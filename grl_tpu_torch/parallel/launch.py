"""Start the ranks of a data-parallel group on this host.

``launch(fn, args, n)`` runs ``fn(args)`` in ``n`` new processes (spawned,
so each starts clean), rank i on ``cuda:i`` over NCCL, or over gloo when
``device`` is the CPU; with ``here``, this process joins as rank 0 and
runs ``here()`` (a daemon keeps its own stdin, streams and signal
handling), and the new processes are ranks 1 to n-1. More CUDA ranks
than cards share them over gloo (``init_group``). The rendezvous is a
``FileStore`` in a fresh directory (no port to pick or race for). The parent forwards SIGTERM and
SIGINT to every rank, waits for them all, and raises as soon as one exits
non-zero (the others are killed: they would wait forever in a collective),
or at ``timeout``. A CPU rank runs one thread. Each rank that returns writes its result, and
``launch`` returns them in rank order. The ranks die with the parent.
"""

from __future__ import annotations

import os
import pickle
import shutil
import signal
import tempfile
import threading
import time
import uuid
from multiprocessing.connection import wait

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .multihost import coordination_barrier, destroy_group, init_group


def _die_with_parent():
    """A rank gets SIGKILL when the launching process dies (Linux)."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _rank_main(fn, args, rank, nprocs, device, store_path, result_path, multihost):
    _die_with_parent()
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores, and gloo ranks are for tests and
        # rehearsals: one thread each (torch's default, every core in every
        # rank, ran a 2-rank step 12x slower on an 8-core host)
        torch.set_num_threads(1)
    init_group(rank, nprocs, device, store=dist.FileStore(store_path, nprocs), multihost=multihost)
    result = fn(args)
    with open(result_path.format(rank=rank), "wb") as f:
        pickle.dump(result, f)
    # every rank is past its last collective before any leaves the group
    coordination_barrier("launch_exit")
    destroy_group()


def launch(fn, args, nprocs, device="cuda", workdir=None, timeout=None, multihost=False, here=None):
    """Run ``fn(args)`` on ``nprocs`` ranks of a new group; returns each
    rank's return value, in rank order. ``multihost`` makes the ranks stand
    for grl_tpu's processes (``Mesh.multihost``). Raises ``RuntimeError``
    when a rank fails and ``TimeoutError`` past ``timeout`` seconds (the
    new ranks' wait, after ``here`` returns).

    ``here``: a callable that this process runs as rank 0, in the group,
    in place of ``fn``; signals are then this process's own to handle (none
    is forwarded), and the other ranks die with it."""
    device = torch.device(device)
    own_dir = workdir is None
    workdir = tempfile.mkdtemp(prefix="grl_launch_") if own_dir else os.fspath(workdir)
    run = uuid.uuid4().hex[:12]
    store_path = os.path.join(workdir, f"rendezvous-{run}")
    result_path = os.path.join(workdir, f"result-{run}-{{rank}}.pkl")
    ctx = mp.get_context("spawn")
    first = 0 if here is None else 1
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, args, r, nprocs, str(device), store_path, result_path, multihost))
             for r in range(first, nprocs)]

    def forward(signum, _frame):
        for p in procs:
            if p.pid is not None and p.exitcode is None:
                os.kill(p.pid, signum)

    previous = []
    if here is None and threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            previous.append((sig, signal.signal(sig, forward)))
    try:
        for p in procs:
            p.start()
        results = []
        if here is not None:
            init_group(0, nprocs, device, store=dist.FileStore(store_path, nprocs), multihost=multihost)
            try:
                results.append(here())
                coordination_barrier("launch_exit")
            finally:
                destroy_group()
        deadline = None if timeout is None else time.monotonic() + timeout
        running = list(procs)
        while running:
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                raise TimeoutError(f"the {nprocs} ranks did not finish within {timeout} s")
            wait([p.sentinel for p in running], timeout=left)
            for p in [p for p in running if p.exitcode is not None]:
                running.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError(f"{p.name} of {nprocs} exited with code {p.exitcode}")
        return results + [_read(result_path.format(rank=r)) for r in range(first, nprocs)]
    finally:
        for sig, handler in previous:
            signal.signal(sig, handler)
        for p in procs:
            if p.exitcode is None and p.pid is not None:
                p.kill()
            p.join()
        if own_dir:
            shutil.rmtree(workdir, ignore_errors=True)
        else:
            for name in os.listdir(workdir):
                if run in name:
                    os.remove(os.path.join(workdir, name))


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)
