"""Multi-process data parallelism: catalog shards, striped evaluation, and
the group's start-up (counterpart of ``grl_tpu/parallel/multihost.py``).

In grl_tpu a pod runs one process per host over a global mesh: each
process takes a slice of the train catalog by identity and loads
``global_batch / processes`` clips per step, and the evaluation catalogs
are striped over the processes. The port's ranks play grl_tpu's
processes: under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) each rank is one process on
``cuda:LOCAL_RANK``, and the result equals grl_tpu's run with that many
processes of one device each.

``shard_catalog``, ``_assign_pids``, ``min_shard_size``, ``stripe_catalog``
and ``eval_catalog_meta`` are grl_tpu's, copied (pure Python and numpy);
their default process index and count are this rank's and the group's.
``_harden_cpu_gloo`` and ``GRL_DISTRIBUTED_AUTODETECT`` tune XLA's CPU
collectives and TPU pods and have no counterpart here.
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, _set_mesh, current_mesh

# how long a rank waits for its peers at the rendezvous and in a collective
GROUP_TIMEOUT = timedelta(minutes=30)


def init_group(rank, world_size, device="cuda", store=None, multihost=False, local_rank=None):
    """Join the default process group and return this rank's :class:`Mesh`.

    NCCL over ``cuda:local_rank`` (default ``rank``) when ``device`` is a
    CUDA device, gloo on the CPU; a gloo group beside NCCL carries the
    host-side values. A group that fails to form raises."""
    device = torch.device(device)
    kwargs = dict(store=store, rank=rank, world_size=world_size, timeout=GROUP_TIMEOUT)
    if device.type == "cuda":
        index = rank if local_rank is None else local_rank
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
        dist.init_process_group("nccl", device_id=device, **kwargs)
        host_group = dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)
    else:
        dist.init_process_group("gloo", **kwargs)
        host_group = None
    mesh = Mesh(rank, world_size, device, host_group=host_group, store=store, multihost=multihost)
    _set_mesh(mesh)
    establish_collectives()
    return mesh


def destroy_group():
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _set_mesh(None)


def maybe_initialize_distributed(device="cuda"):
    """This process's :class:`Mesh`: the live group's, else one formed from
    ``torchrun``'s environment, else None (``WORLD_SIZE`` unset or 1: one
    process).

    The rendezvous store is the one at ``MASTER_ADDR:MASTER_PORT``: served
    by ``torchrun``'s agent when it says so
    (``TORCHELASTIC_USE_AGENT_STORE``), else by rank 0. NCCL on
    ``cuda:LOCAL_RANK`` when ``device`` is CUDA, gloo on the CPU."""
    mesh = current_mesh()
    if mesh is not None:
        return mesh
    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return None
    rank = int(os.environ["RANK"])
    agent_store = os.environ.get("TORCHELASTIC_USE_AGENT_STORE") == "True"
    store = dist.TCPStore(os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"]), world_size,
                          is_master=rank == 0 and not agent_store, timeout=GROUP_TIMEOUT)
    return init_group(rank, world_size, device, store=store, multihost=True,
                      local_rank=int(os.environ.get("LOCAL_RANK", rank)))


def establish_collectives():
    """One barrier collective right after the group forms, on the device
    group and on the host group, so both transports connect while every
    rank is still in step from the rendezvous."""
    mesh = current_mesh()
    dist.all_reduce(torch.zeros(1, device=mesh.device))
    if mesh.host_group is not None:
        dist.all_reduce(torch.zeros(1), group=mesh.host_group)


_BARRIER_SEQ = {}


def coordination_barrier(name, timeout_s=600.0):
    """Block until every rank reaches this barrier, through the rendezvous
    store (no device collective), waiting at most ``timeout_s``. Each
    name's uses are numbered, so ranks call with the same names in the same
    order. No-op without a group or with one rank."""
    mesh = current_mesh()
    if mesh is None or mesh.size <= 1:
        return
    seq = _BARRIER_SEQ.get(name, 0)
    _BARRIER_SEQ[name] = seq + 1
    key = f"grl_tpu:{name}:{seq}"
    if mesh.store.add(key, 1) == mesh.size:
        mesh.store.set(f"{key}:done", "1")
    mesh.store.wait([f"{key}:done"], timedelta(seconds=timeout_s))


def _process_index():
    mesh = current_mesh()
    return 0 if mesh is None else mesh.rank


def _process_count():
    mesh = current_mesh()
    return 1 if mesh is None else mesh.size


def shard_catalog(tracklets, process_index=None, process_count=None):
    """Deterministic per-process slice of a train catalog, by identity.

    Identities are greedily balanced by tracklet count (largest first), so
    processes get near-equal work; whole pids stay on one process, so the
    pair sampler always finds a same-pid positive locally. pids keep their
    global values: the OIM lookup tables are global state."""
    if process_index is None:
        process_index = _process_index()
    if process_count is None:
        process_count = _process_count()
    if process_count == 1:
        return list(tracklets)
    assignment, _ = _assign_pids(tracklets, process_count)
    return [item for item in tracklets if assignment[item[1]] == process_index]


def _assign_pids(tracklets, process_count):
    """Greedy balance: biggest pid groups first, each to the currently
    lightest process (ties by process id). Returns (pid -> process,
    per-process tracklet loads)."""
    by_pid = {}
    for item in tracklets:
        by_pid.setdefault(item[1], []).append(item)
    loads = [0] * process_count
    assignment = {}
    for pid in sorted(by_pid, key=lambda p: (-len(by_pid[p]), p)):
        target = min(range(process_count), key=lambda i: (loads[i], i))
        assignment[pid] = target
        loads[target] += len(by_pid[pid])
    return assignment, loads


def min_shard_size(tracklets, process_count=None):
    """Smallest per-process tracklet count under :func:`shard_catalog`'s
    assignment. Every process computes it alike and caps its epoch to the
    same step count: a process with more steps would wait forever in the
    gradient reduction of a step its peers never take."""
    if process_count is None:
        process_count = _process_count()
    if process_count == 1:
        return len(tracklets)
    _, loads = _assign_pids(tracklets, process_count)
    return min(loads)


def stripe_catalog(tracklets, process_index=None, process_count=None, local_devices=1):
    """Equal contiguous stripes of an eval catalog, one per process: each
    takes ``k = ceil(n / P)`` consecutive items (rounded up to a multiple of
    ``local_devices``; one per rank in the port), trailing processes
    repeating the last item as padding. The assembled rows are the catalog
    order with every pad row at the tail, which :func:`gather_striped_rows`
    drops. Returns ``(local_tracklets, n_total, k)``."""
    if process_index is None:
        process_index = _process_index()
    if process_count is None:
        process_count = _process_count()
    n = len(tracklets)
    if n == 0:
        raise ValueError("cannot stripe an empty catalog")
    k = -(-n // process_count)
    k = -(-k // local_devices) * local_devices
    start = process_index * k
    local = [tracklets[min(i, n - 1)] for i in range(start, start + k)]
    return local, n, k


def eval_catalog_meta(tracklets):
    """``(n_total, pids, camids)`` of one whole eval catalog: one split's
    entry of ``Evaluator.evaluate``'s ``multihost`` dict."""
    return (len(tracklets), np.asarray([t[1] for t in tracklets]), np.asarray([t[2] for t in tracklets]))


def gather_striped_rows(local_rows, n_total, mesh):
    """Every rank's ``(k, C)`` stripe (a tensor on the rank's device)
    gathered in rank order, tail pad rows dropped: ``(n_total, C)`` on
    every rank."""
    local_rows = torch.as_tensor(local_rows, device=mesh.device).contiguous()
    parts = [torch.empty_like(local_rows) for _ in range(mesh.size)]
    dist.all_gather(parts, local_rows)
    return torch.cat(parts)[:n_total]

