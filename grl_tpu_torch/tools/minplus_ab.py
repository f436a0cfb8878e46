"""Time the min-plus kernel against the first design's source, in turns on one card.

    git show <commit>:grl_tpu_torch/csrc/minplus.cu > build/ab/minplus_old.cu
    python3 -m grl_tpu_torch.tools.minplus_ab --old build/ab/minplus_old.cu

The ``--old`` source has the first design's entry point,
``grl_minplus_f32(a, b, out, m, n, k, stream)`` on contiguous operands.
Both builds run at the same shape on the same inputs, in the order old,
new, new, old (``--turns`` times), each turn timed over ``--reps`` launches
with CUDA events; the card's name, power limit, clocks and power draw are
sampled beside the turns. Prints one JSON line per turn and a summary
line, and raises if the two disagree by more than 1e-5.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from .. import set_precision
from ..ops.build import BUILD_INFO, load_library
from ..ops.minplus import minplus, padded_empty

TOL = 1e-5  # fp32 sums of row-normalized values (≤ 1) in another order


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def old_kernel(source):
    lib = load_library("minplus_old", [str(Path(source).resolve())])
    fn = lib.grl_minplus_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(a, b):
        out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0], a.shape[1], stream)
        if err != 0:
            raise RuntimeError(f"old minplus kernel launch failed: CUDA error {err}")
        return out

    return run


def timed(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", required=True, help="the first design's minplus.cu to build and time")
    p.add_argument("--shape", type=int, nargs=3, default=[1980, 13290, 13290], metavar=("M", "N", "K"))
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--turns", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("minplus_ab: no CUDA device")
    set_precision()  # the CLIs' policy (the min-plus contraction reads no TF32 flag)

    m, n, k = args.shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    # row-normalized, in 16-byte aligned rows as re-ranking builds V
    a, b = (padded_empty(rows, k, "cuda").copy_(torch.rand(rows, k, device="cuda", generator=gen))
            for rows in (m, n))
    a /= a.sum(dim=1, keepdim=True)
    b /= b.sum(dim=1, keepdim=True)

    old = old_kernel(args.old)
    a_dense, b_dense = a.contiguous(), b.contiguous()  # the first design's operands
    runs = {"old": lambda: old(a_dense, b_dense), "new": lambda: minplus(a, b)}
    diff = float((runs["old"]() - runs["new"]()).abs().max())
    torch.cuda.synchronize()
    ptxas = {name: [ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln]
             for name, info in BUILD_INFO.items()}
    print(json.dumps({"card": smi("name,power.limit"), "clocks_max_sm": smi("clocks.max.sm"),
                      "shape": [m, n, k], "max_abs_diff_old_vs_new": diff, "ptxas": ptxas}), flush=True)
    if diff > TOL:
        raise RuntimeError(f"the old and new minplus disagree by {diff}")

    times = {name: [] for name in runs}
    for _ in range(args.turns):
        for name in ("old", "new", "new", "old"):
            ms = timed(runs[name], args.reps)
            times[name].append(ms)
            print(json.dumps({"turn": name, "ms": ms, "clocks_sm_power_draw": smi("clocks.sm,power.draw")}),
                  flush=True)
    print(json.dumps({"summary": "minplus_ab", "shape": [m, n, k], "ms": times,
                      "best_ms": {name: min(v) for name, v in times.items()},
                      "card": smi("name,power.limit")}), flush=True)


if __name__ == "__main__":
    main()
