"""The data-parallel group and its helpers (counterpart of
``grl_tpu/parallel/mesh.py``).

grl_tpu runs SPMD over a 1-axis ``jax.sharding.Mesh``: the train state is
replicated, the batch's pair axis sharded, and XLA inserts the collectives.
The port runs one process per card, PyTorch's idiom: a :class:`Mesh` is
the process group (``torch.distributed``'s default group: NCCL over CUDA
tensors, gloo over CPU ones), this rank's place in it and its device. A
rank holds a contiguous slice of each global batch (whole anchor/positive
pairs, as grl_tpu's shards), and the group step (``engine/train_step.py``)
makes the result that of one card on the global batch: global-batch
BatchNorm in the CNN (``nn/norm.py``), the CNN's outputs gathered in rank
order before the heads and losses, and the gradients summed over the
ranks.

``auto_mesh`` decides how many ranks a CLI launches (grl_tpu's rule: every
visible card by default, capped by ``--devices``, and the largest count
that divides the pairs); the ranks themselves are started by
``parallel/launch.py`` or by ``torchrun`` (``parallel/multihost.py``).
Rank i of a CLI's own launch runs on ``cuda:i``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A 1-axis data mesh: the default process group, this rank, the world
    size and this rank's device.

    ``host_group`` is a gloo group over the same ranks for host-side values
    (the batch's ids, the stop flag), so they never wait on the device's
    queue; with gloo as the backend it is the default group. ``store`` is
    the rendezvous store (``coordination_barrier``). ``multihost`` marks a
    launch whose ranks stand for grl_tpu's processes (``torchrun``: the
    train catalog is sharded by identity); otherwise the ranks stand for
    the devices of grl_tpu's one-process mesh (every rank draws the global
    batch and loads its slice)."""

    def __init__(self, rank, size, device, *, host_group=None, store=None, multihost=False, axis="data"):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.host_group = host_group
        self.store = store
        self.multihost = multihost
        self.axis_names = (axis,)

    @property
    def shape(self):
        return {self.axis_names[0]: self.size}

    def __repr__(self):
        kind = "multihost" if self.multihost else "local"
        return f"Mesh(rank={self.rank}, size={self.size}, device={self.device}, {kind})"

    def gather_host(self, array):
        """Every rank's host ``array`` (same shape on each) concatenated
        along axis 0 in rank order, as numpy."""
        t = torch.as_tensor(np.ascontiguousarray(array))
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.host_group)
        return torch.cat(parts).numpy()

    def any_host(self, flag):
        """True on every rank when ``flag`` is true on any rank."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return bool(t.item())


_MESH = None


def current_mesh():
    """The mesh of this process's live group, or None."""
    return _MESH


def _set_mesh(mesh):
    global _MESH
    _MESH = mesh


def data_mesh(n_devices=None):
    """The mesh of this process's live group. ``n_devices``, where given,
    must be the group's size: a group's ranks are fixed when it forms
    (``auto_mesh`` decides how many to launch)."""
    if _MESH is None:
        raise RuntimeError("no process group: launch the ranks first (parallel.launch, or torchrun)")
    if n_devices is not None and n_devices != _MESH.size:
        raise ValueError(f"the group has {_MESH.size} ranks, not {n_devices}")
    return _MESH


def visible_devices(device="cuda"):
    """Cards a launch may use: the visible CUDA devices; None on the CPU
    (gloo ranks are processes, with no device count to cap them)."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else None


def auto_mesh(pairs=None, limit=None, device="cuda"):
    """How many ranks a CLI launches, by grl_tpu's ``auto_mesh`` rule: every
    visible card (``limit``, the CLI's ``--devices``, caps it; 0 or None
    means every card), then the largest count that divides ``pairs``
    (train batch // 2) so every rank holds whole pairs. On the CPU there is
    no card count: the count is ``limit`` (1 when None). Returns an int;
    1 means one process and no group."""
    available = visible_devices(device)
    n = (limit or 1) if available is None else available
    if limit and available is not None:
        n = min(n, limit)
    if pairs is not None:
        while n > 1 and pairs % n != 0:
            n -= 1
    return max(n, 1)


def replicate(obj, mesh):
    """Broadcast ``obj``'s tensors from rank 0 in place: a module's
    parameters and buffers, or a ``TrainState``'s modules, luts and
    momentum buffers. Returns ``obj``."""
    with torch.no_grad():
        for t in _tensors(obj):
            dist.broadcast(t, src=0)
    return obj


def _tensors(obj):
    if isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
        return
    yield from _tensors(obj.models)
    for name in sorted(obj.luts):
        yield obj.luts[name]
    for group in obj.optimizer.param_groups:
        for p in group["params"]:
            buf = obj.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                yield buf


def shard_batch(array, mesh, axis="data"):
    """This rank's contiguous slice of the leading (batch/pair) axis."""
    n = mesh.shape[axis]
    if array.shape[0] % n != 0:
        raise ValueError(f"batch {array.shape[0]} not divisible by mesh axis {n}")
    k = array.shape[0] // n
    return array[mesh.rank * k:(mesh.rank + 1) * k]


def sharded_train_state(train_state, mesh):
    """Ready ``train_state`` for the group step: every BatchNorm of the CNN
    normalizes with global-batch statistics (the heads run on the gathered
    global batch already), and every tensor is rank 0's. In place; returns
    it."""
    from ..nn import convert_global_batchnorm

    convert_global_batchnorm(train_state.models["cnn"])
    return replicate(train_state, mesh)

