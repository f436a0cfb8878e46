"""Min-plus "matmul": ``S[i, j] = Σ_t min(a[i, t], b[j, t])``.

The Jaccard min-sum of k-reciprocal re-ranking. On the card it runs the
hand-written CUDA kernel ``grl_tpu_torch/csrc/minplus.cu``, which replaces
the TPU kernel ``grl_tpu/ops/minplus.py::_minplus_kernel``; the source's
header says what bounds it and how it is tiled. ``minplus_plain`` is the
same function in plain PyTorch: the CPU path, and the kernel's yardstick
of correctness.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library


def minplus_plain(a, b, chunk_elems=None):
    """Chunked broadcast ``torch.minimum(a[:, None, :], b[None, :, :]).sum(-1)``.

    Each chunk's (rows_a, rows_b, k) temporary holds at most ``chunk_elems``
    elements (default 2^24 on the CPU, 2^28 on a card)."""
    if chunk_elems is None:
        chunk_elems = 1 << (24 if a.device.type == "cpu" else 28)
    m, k = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    rows_b = max(1, min(n, chunk_elems // max(k, 1)))
    rows_a = max(1, min(m, chunk_elems // max(rows_b * k, 1)))
    for i in range(0, m, rows_a):
        for j in range(0, n, rows_b):
            out[i : i + rows_a, j : j + rows_b] = torch.minimum(
                a[i : i + rows_a, None, :], b[None, j : j + rows_b, :]
            ).sum(-1)
    return out


def _lib():
    lib = load_library("minplus", ["minplus.cu"])
    fn = lib.grl_minplus_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def minplus(a, b):
    """``S[i, j] = Σ_t min(a[i, t], b[j, t])`` for fp32 a (m, k), b (n, k).

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    ``minplus_plain``. ``minplus.launches`` counts kernel launches."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"minplus takes (m, k) and (n, k); got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"minplus takes float32; got {a.dtype}, {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"minplus operands on {a.device} and {b.device}")
    if a.device.type == "cpu":
        return minplus_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"minplus runs on CUDA or CPU tensors, not {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus takes contiguous operands")
    m, k = a.shape
    n = b.shape[0]
    if max(m, n, k) >= 2**31:
        raise ValueError(f"minplus sizes must fit in int32: {tuple(a.shape)}, {tuple(b.shape)}")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    fn = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    minplus.launches += 1
    return out


minplus.launches = 0
