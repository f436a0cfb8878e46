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


# cap on the k-parts of one tile: the fixup reads every part's tile back
MAX_SPLITS = 8
# a part takes at least this many k-chunks, so its pipeline runs past the prologue
MIN_CHUNKS_PER_PART = 4


def schedule(m, n, k, tile, slots):
    """The persistent kernel's work split: ``(grid, dp_tiles, splits)``.

    ``tile = (BM, BN, BK)``; ``slots`` is how many blocks the card holds at
    once (SMs × blocks per SM). Tiles that fill whole rounds of ``slots``
    run at full k; the tiles of the last, partial round (``dp_tiles`` and
    on) are each cut along k into ``splits`` parts, so that round has about
    as many units as there are slots. ``grid`` is the number of blocks."""
    bm, bn, bk = tile
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // bk)
    rounds, tail = divmod(tiles, slots)
    dp_tiles = rounds * slots
    splits = 1
    if tail:
        splits = max(1, min(slots // tail, chunks // MIN_CHUNKS_PER_PART, MAX_SPLITS))
    grid = slots if rounds else tail * splits
    return grid, dp_tiles, splits


def _lib():
    """The kernel's library, built at first use."""
    lib = load_library("minplus", ["minplus.cu"])
    lib.grl_minplus_f32.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
                                    + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.grl_minplus_f32.restype = ctypes.c_int
    lib.grl_minplus_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.grl_minplus_config.restype = ctypes.c_int
    return lib


_CONFIG = {}  # device index -> (tile, slots)


def _config(device):
    """The kernel's tile and the card's block slots, queried once per card
    (the query also sets the kernel's shared-memory limit there)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _CONFIG:
        cfg = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            err = _lib().grl_minplus_config(cfg)
        if err != 0 or cfg[3] < 1:
            raise RuntimeError(f"minplus kernel cannot be resident on {device}: "
                               f"CUDA error {err}, {cfg[3]} blocks per SM")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        _CONFIG[index] = ((cfg[0], cfg[1], cfg[2]), sms * cfg[3])
    return _CONFIG[index]


def padded_empty(rows, k, device=None):
    """An uninitialized fp32 (rows, k) view whose row stride is k rounded up
    to 4 floats (16 bytes): rows the kernel's TMA copies can read."""
    return torch.empty((rows, -(-k // 4) * 4), dtype=torch.float32, device=device)[:, :k]


def aligned(x):
    """``x`` when the kernel's TMA copies can read it (16-byte aligned start
    and row stride, rows not overlapping), else a copy in ``padded_empty``
    rows: one read and one write of ``x`` (PERF.md gives the cost)."""
    rows, k = x.shape
    if k == 0 or (x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0 and x.stride(0) >= k):
        return x
    return padded_empty(rows, k, x.device).copy_(x)


def _launch(a, b):
    """Run the kernel on checked CUDA operands and count the launch; returns S."""
    a, b = aligned(a), aligned(b)
    lda, ldb = row_strides(a, b)
    m, k = a.shape
    n = b.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    with torch.cuda.device(a.device):
        tile, slots = _config(a.device)
        grid, dp_tiles, splits = schedule(m, n, k, tile, slots)
        workspace = counters = None
        if splits > 1:
            tail = -(-m // tile[0]) * -(-n // tile[1]) - dp_tiles
            workspace = torch.empty(tail * splits * tile[0] * tile[1], dtype=torch.float32,
                                    device=a.device)
            counters = torch.zeros(tail, dtype=torch.int32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _lib().grl_minplus_f32(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, lda, ldb,
            workspace.data_ptr() if splits > 1 else None,
            counters.data_ptr() if splits > 1 else None, grid, dp_tiles, splits, stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    minplus.launches += 1
    return out


def row_strides(a, b):
    """``(lda, ldb)`` of (m, k) and (n, k) operands with a unit column
    stride and every size in int32; raises otherwise."""
    k = a.shape[1]
    if k > 1 and (a.stride(1) != 1 or b.stride(1) != 1):
        raise ValueError(f"minplus takes operands with unit column stride; got {a.stride()}, {b.stride()}")
    lda, ldb = a.stride(0), b.stride(0)
    if max(a.shape[0], b.shape[0], k, lda, ldb) >= 2**31:
        raise ValueError(f"minplus sizes must fit in int32: {tuple(a.shape)}, {tuple(b.shape)}")
    return lda, ldb


def minplus(a, b):
    """``S[i, j] = Σ_t min(a[i, t], b[j, t])`` for fp32 a (m, k), b (n, k).

    A CUDA tensor launches the kernel or raises; a CPU tensor takes
    ``minplus_plain``. On the card each operand needs a unit column stride;
    operands whose start or row stride is not 16-byte aligned are copied
    into padded rows first (``aligned``), so a row or column slice of a
    ``padded_empty`` matrix runs without a copy. ``minplus.launches``
    counts kernel launches."""
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
    row_strides(a, b)
    return _launch(a, b)


minplus.launches = 0
