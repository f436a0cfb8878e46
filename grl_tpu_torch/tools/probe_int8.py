"""Probe: is int8 compute a viable speed-up for the eval path on the card?
(counterpart of ``tools/probe_int8.py``).

The H100 data sheet rates dense int8 on the tensor cores at twice dense
bf16 (``utils.profiling``: ``PEAK_INT8_OPS``, ``PEAK_BF16_OPS``). This
measures what PyTorch delivers for the shapes grl_tpu's probe asks about:

1. an int8 x int8 -> int32 product at 8192^3 (``torch._int_mm``) against
   a bf16 ``torch.matmul`` of the same operands, with B as it is
   (row-major) and with the same B laid out column-major (cuBLASLt's int8
   kernels favour one operand order); the int8 products' 64x64 corner is
   held exact against an int64 product on the host;
2. an int8 3x3 convolution at layer3's shape (128 frames x 1024 channels
   x 16x8, 1024 -> 1024, ``F.conv2d``) against bf16; where PyTorch rejects
   int8 on the device the probe prints ``REJECTED`` with the error's first
   200 characters, as grl_tpu's does; where it accepts it, the output's
   dtype and whether its corner is the exact sum (an int8 output wraps);
3. the im2col fallback of grl_tpu's probe: nine shifted copies
   (``torch.roll``, so the borders wrap), stacked into (frames x h x w,
   9 x 1024) and multiplied by the weights with ``torch._int_mm``;
   ``F.unfold`` is not built for int8; the weights row-major and
   column-major. Its 64x64 corner is held exact against the same
   construction in int64 on the host.

Each line gives ms, TOP/s and, on the card, the share of the data-sheet
peak of its type. Times are CUDA-event windows of ``ITERS`` calls after
one warm call (the host clock on the CPU). These are library calls: no
kernel of the port is involved.

    python3 -m grl_tpu_torch.tools.probe_int8 [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, set_precision
from ..utils.profiling import PEAK_BF16_OPS, PEAK_INT8_OPS, card_line, window_ms

N = 8192  # side of the square products
CONV = (128, 1024, 16, 8, 1024)  # grl_tpu's layer3 shape: frames, in channels, h, w, out channels
ITERS = 8  # calls per timed window
CORNER = 64  # rows and columns held exact against int64 on the host


def _rate(ms, ops, peak, device):
    return {"ms": ms, "tops": ops / (ms * 1e-3) / 1e12,
            "peak_share": ops / (ms * 1e-3) / peak if device.type == "cuda" else None}


def _timed(fn, iters, ops, peak, device):
    fn()  # the library's set-up, the allocator
    return _rate(window_ms(fn, iters, device) / iters, ops, peak, device)


def im2col(x):
    """grl_tpu's im2col of a 3x3 'SAME' conv on NHWC ``x``: nine copies
    shifted by ``torch.roll`` (borders wrap), (b*h*w, 9*c)."""
    b, h, w, c = x.shape
    return torch.stack([torch.roll(x, (-dy, -dx), dims=(1, 2)) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
                       dim=3).reshape(b * h * w, 9 * c)


def im2col_rows_int64(x_np, rows):
    """The first ``rows`` rows of ``im2col`` in int64 on the host."""
    b, h, w, c = x_np.shape
    out = np.empty((rows, 9 * c), np.int64)
    for r in range(rows):
        n, i, j = r // (h * w), (r // w) % h, r % w
        out[r] = np.concatenate([x_np[n, (i + dy) % h, (j + dx) % w] for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    return out


def probe(device="cuda", n=N, conv=CONV, iters=ITERS):
    """The readings as a dict: ``matmul_int8``, ``matmul_bf16``,
    ``conv_int8`` (or its rejection), ``conv_bf16``, ``im2col_int8``, each
    with ms, TOP/s and the peak share, and the exactness checks."""
    device = resolve_device(device)
    rng = np.random.RandomState(0)
    out = {"device": str(device), "n": n, "conv": list(conv), "iters": iters}
    c = CORNER

    a_np = rng.randint(-127, 127, (n, n)).astype(np.int8)
    b_np = rng.randint(-127, 127, (n, n)).astype(np.int8)
    a8, b8 = torch.from_numpy(a_np).to(device), torch.from_numpy(b_np).to(device)
    abf, bbf = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
    ops = 2.0 * n * n * n
    want = a_np[:c].astype(np.int64) @ b_np[:, :c].astype(np.int64)
    # B as it is (row-major, grl_tpu's operands) and the same B column-major
    for key, b in (("matmul_int8", b8), ("matmul_int8_b_colmajor", b8.t().contiguous().t())):
        try:
            got = torch._int_mm(a8, b)
        except (RuntimeError, NotImplementedError) as e:
            out[key] = {"rejected": f"{type(e).__name__}: {str(e)[:200]}"}
            continue
        out[key] = {**_timed(lambda: torch._int_mm(a8, b), iters, ops, PEAK_INT8_OPS, device),
                    "out_dtype": str(got.dtype).removeprefix("torch."),
                    "exact": bool(np.array_equal(got[:c, :c].cpu().numpy().astype(np.int64), want))}
        del got, b
    out["matmul_bf16"] = _timed(lambda: torch.matmul(abf, bbf), iters, ops, PEAK_BF16_OPS, device)
    del a8, b8, abf, bbf

    bsz, cin, h, w, k = conv
    x_np = rng.randint(-127, 127, (bsz, h, w, cin)).astype(np.int8)  # NHWC, as grl_tpu's
    w_np = rng.randint(-127, 127, (3, 3, cin, k)).astype(np.int8)  # HWIO
    x8 = torch.from_numpy(x_np).to(device)
    w8 = torch.from_numpy(w_np).to(device)
    x8_nchw = x8.permute(0, 3, 1, 2).contiguous()
    w8_oihw = w8.permute(3, 2, 0, 1).contiguous()
    cops = 2.0 * bsz * h * w * 9 * cin * k
    try:
        got = F.conv2d(x8_nchw, w8_oihw, padding=1)
    except (RuntimeError, NotImplementedError) as e:
        out["conv_int8"] = {"rejected": f"{type(e).__name__}: {str(e)[:200]}"}
    else:
        # output (0, :c, 1, 1): an interior pixel, no padding in its window
        want = np.einsum("hwi,hwio->o", x_np[0, 0:3, 0:3].astype(np.int64), w_np[:, :, :, :c].astype(np.int64))
        out["conv_int8"] = {**_timed(lambda: F.conv2d(x8_nchw, w8_oihw, padding=1), iters, cops, PEAK_INT8_OPS,
                                     device),
                            "out_dtype": str(got.dtype).removeprefix("torch."),
                            "exact": bool(np.array_equal(got[0, :c, 1, 1].cpu().numpy().astype(np.int64), want))}
        del got
    xbf, wbf = x8_nchw.to(torch.bfloat16), w8_oihw.to(torch.bfloat16)
    out["conv_bf16"] = _timed(lambda: F.conv2d(xbf, wbf, padding=1), iters, cops, PEAK_BF16_OPS, device)
    del xbf, wbf, x8_nchw, w8_oihw

    want = im2col_rows_int64(x_np, min(c, bsz * h * w)) @ w_np.reshape(9 * cin, k)[:, :c].astype(np.int64)
    wmat = w8.reshape(9 * cin, k)
    for key, wm in (("im2col_int8", wmat), ("im2col_int8_w_colmajor", wmat.t().contiguous().t())):
        got = torch._int_mm(im2col(x8), wm)
        out[key] = {**_timed(lambda: torch._int_mm(im2col(x8), wm), iters, cops, PEAK_INT8_OPS, device),
                    "out_dtype": str(got.dtype).removeprefix("torch."),
                    "exact": bool(np.array_equal(got[:c, :c].cpu().numpy().astype(np.int64), want))}
        del got, wm
    return out


def _line(label, r, unit):
    if "rejected" in r:
        return f"{label} REJECTED: {r['rejected']}"
    share = "" if r["peak_share"] is None else f", {r['peak_share']:.1%} of peak"
    extra = "".join(f", {k} {r[k]}" for k in ("out_dtype", "exact") if k in r)
    return f"{label}: {r['ms']:.3f} ms = {r['tops']:.1f} {unit}{share}{extra}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_precision()
    print(f"card: {card_line(device)}", flush=True)
    res = probe(device, N, CONV, ITERS)
    n, conv = res["n"], "x".join(map(str, res["conv"]))
    print(_line(f"int8 {n}^3 matmul (_int_mm)", res["matmul_int8"], "TOP/s"))
    print(_line(f"int8 {n}^3 matmul (_int_mm, B column-major)", res["matmul_int8_b_colmajor"], "TOP/s"))
    print(_line(f"bf16 {n}^3 matmul", res["matmul_bf16"], "TFLOP/s"))
    print(_line(f"int8 3x3 conv ({conv})", res["conv_int8"], "TOP/s"))
    print(_line(f"bf16 3x3 conv ({conv})", res["conv_bf16"], "TFLOP/s"))
    print(_line("int8 im2col conv (_int_mm)", res["im2col_int8"], "TOP/s"))
    print(_line("int8 im2col conv (_int_mm, weights column-major)", res["im2col_int8_w_colmajor"], "TOP/s"))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
