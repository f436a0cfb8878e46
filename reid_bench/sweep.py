"""The knee of an open-loop serving cell, found once by a sweep on the chip:

    python -m reid_bench.sweep --workload grl_r50_mars.rerank --rates 4 8 12 16 --seconds 20

One daemon, set up as the cell sets it up; for each offered Poisson rate
one window of the cell's traffic. Prints a JSON line per rate: offered
and completed requests per second, p50 and p95 latency in ms from when a
request was due, and the p95 of the window's first and last quarters
(a backlog that grows through the window shows as the last far above the
first). The knee is the highest rate whose completed rate keeps up and
whose backlog does not grow; the cell runs at about four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import run as harness
from .trace import Spans
from .traffic.rerank_open_loop import Session, latencies_ms


def summarize(rate, w):
    records = w["records"]
    lat = latencies_ms(records)
    done = [r for r in records if r is not None and r[4]]
    span = (max(r[2] for r in done) - w["start_ns"]) / 1e9 if done else float("nan")
    q = max(len(lat) // 4, 1)
    return {"offered": rate, "requests": len(records), "completed_per_s": len(done) / span,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p95_first_quarter_ms": float(np.percentile(lat[:q], 95)),
            "p95_last_quarter_ms": float(np.percentile(lat[-q:], 95))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    wl = harness.workload(args.workload)
    ctx = harness.Context(args.workload, wl, harness.config(wl["config"]), args.seed, args.seconds, False,
                          args.device, time.time(), Spans())
    session = Session(ctx)
    try:
        for i, rate in enumerate(args.rates):
            w = session.window(rate, args.seconds, ctx.rng(100 + i), ctx.spans)
            print(json.dumps({"workload": args.workload, **summarize(rate, w)}), flush=True)
    finally:
        session.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
