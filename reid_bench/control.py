"""Readings that the limits of a cell's check are set from, on the chip:

    python -m reid_bench.control --workload <cell> --seeds 1 2 3 ... [--seconds 3]

For each seed, in one process, one run of the cell (a short window) and,
on the same inputs and weights, the control: the plain reference put in
the program's place at the precision below the one the cell states (the
index cell's bf16 -> float8 e4m3 operands; the training and serving
cells' fp32 -> TF32 operands), and for a training cell the fault of a step that trains
on half of its batch. Prints one JSON line per seed with the program's
numbers and the control's; the limits in the cell's file lie between the
largest program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import run as harness
from .trace import Spans

CONTROLS = {
    "dense_index": {"control": "fp8"},
    "pair_train": {"control": {"tf32": "tf32", "half_batch": "half_batch"}},
    "rerank_open_loop": {"control": "tf32"},
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--precision", default=None,
                    help="run the program at this precision instead of the cell's (a witness: fp32 "
                         "against the fp32 reference)")
    args = ap.parse_args(argv)
    import importlib

    import torch

    wl = harness.workload(args.workload)
    kind = importlib.import_module(f"reid_bench.traffic.{wl['traffic']}")
    for seed in args.seeds:
        cfg = harness.config(wl["config"])
        wl = harness.workload(args.workload)
        wl["precision"] = args.precision or wl["precision"]
        ctx = harness.Context(args.workload, wl, cfg, seed, args.seconds, False, args.device, time.time(), Spans())
        out = kind.run(ctx, **CONTROLS[wl["traffic"]])
        line = {"workload": args.workload, "seed": seed,
                "program": {k: v for k, (v, _) in out.checks.items()}, "control": out.control,
                "end_to_end": out.end_to_end, "setup_s": out.setup_s, "memory_peak_bytes": out.memory_peak_bytes}
        print(json.dumps(line), flush=True)
        del out, ctx
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
