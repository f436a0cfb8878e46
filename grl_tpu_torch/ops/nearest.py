"""Each row's k nearest columns: ``argsort(x, dim=1, stable=True)[:, :k]``.

k-reciprocal re-ranking's neighbour lists. On the card it runs the
hand-written CUDA kernel ``grl_tpu_torch/csrc/nearest.cu``, an exact
selection that reads each row once; it replaces no TPU kernel (grl_tpu
picks these lists with ``jax.lax.top_k``), and the source's header says
what bounds it and how it selects. ``nearest_plain`` is the same function
in plain PyTorch: the CPU path, and the kernel's yardstick of correctness.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

# the most columns a row may have: 512 threads of 64 columns, the row's keys
# in the kernel's shared memory
MAX_COLUMNS = 32768


def nearest_plain(x, k):
    """The first ``min(k, n)`` columns of each row's stable ascending order.

    A stable ascending argsort orders exactly as ``jax.lax.top_k(-x, k)``
    does (largest of -x first, ties to the lower index); ``torch.topk``
    breaks ties in no fixed order."""
    return torch.argsort(x, dim=1, stable=True)[:, :k]


def _lib():
    """The kernel's library, built at first use."""
    lib = load_library("nearest", ["nearest.cu"])
    lib.grl_nearest_f32.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int]
                                    + [ctypes.c_void_p])
    lib.grl_nearest_f32.restype = ctypes.c_int
    return lib


def _launch(x, k):
    """Run the kernel on a checked CUDA ``x`` and count the launch; returns
    the (rows, k) int64 indices."""
    rows, n = x.shape
    out = torch.empty((rows, k), dtype=torch.int64, device=x.device)
    if rows == 0 or k == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().grl_nearest_f32(x.data_ptr(), out.data_ptr(), rows, n, x.stride(0), k, stream)
    if err != 0:
        raise RuntimeError(f"nearest kernel launch failed: CUDA error {err}")
    nearest_k.launches += 1
    return out


def nearest_k(x, k):
    """Each row's ``k`` nearest columns of fp32 ``x`` (rows, n), as int64
    (rows, min(k, n)): ascending, ties to the lower index, the first
    columns of ``torch.argsort(x, dim=1, stable=True)``.

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    ``nearest_plain``. Both take any ``k >= 0``, rows of at most
    ``MAX_COLUMNS`` with unit column stride (any row stride), and raise on
    anything else. ``nearest_k.launches`` counts kernel launches."""
    if x.dim() != 2:
        raise ValueError(f"nearest_k takes a (rows, n) matrix; got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"nearest_k takes float32; got {x.dtype}")
    rows, n = x.shape
    if k < 0:
        raise ValueError(f"nearest_k takes k >= 0; got {k}")
    if n > MAX_COLUMNS:
        raise ValueError(f"nearest_k takes rows of at most {MAX_COLUMNS} columns; got {n}")
    if n > 1 and x.stride(1) != 1:
        raise ValueError(f"nearest_k takes rows with unit column stride; got strides {x.stride()}")
    if rows >= 2**31:
        raise ValueError(f"nearest_k takes fewer than 2^31 rows; got {rows}")
    if x.device.type == "cpu":
        return nearest_plain(x, k)
    if x.device.type != "cuda":
        raise ValueError(f"nearest_k runs on CUDA or CPU tensors, not {x.device}")
    return _launch(x, min(k, n))


nearest_k.launches = 0
