#!/usr/bin/env python3
"""The rrs_test row path (``cli.train``'s periodic evaluation) on two trees
of the port side by side on one card: the record behind PERF.md §5's rows
on padding each chunk to its bucket (``Evaluator.describe_clips``).

    python3 docs/rrs_pad/rrs_ab.py --parent build/parent --out build/rrs

``--parent`` is an unpacked checkout of another commit (``git archive``);
the change is the checkout this script lies in. Runs go in the order
parent, change, change, parent, each in a process of its own started in
its tree, under the CLIs' precision policy, with ``cli.train``'s fp32
models at full width (seed 0) and its evaluation's sizes: loader batches
of 30 clips (``eval_batch_size``), micro-batch 96, 8 x 256x128 frames.

- ``rows``: ``Evaluator._extract_rows`` over in-memory batches of seeded
  uint8 clips, 20 of 30 and a last one of 10: the descriptor and the
  copies to the card alone. One warm pass, then ``PASSES`` passes, each
  ending on a host read of the features.
- ``loader``: ``Evaluator.extract_features`` over a ``ClipLoader``
  (``rrs_test``, batch 30, 8 workers) of a synthetic catalog's gallery
  (the path as ``cli.train`` runs it); one warm pass, then ``PASSES``.

Each run's record is one line of ``OUT/runs.jsonl`` (seconds per pass,
the features' checksum); ``OUT/summary.json`` gathers them by tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PASSES = 3

RUN = r"""
import json, sys, time
import numpy as np, torch
from grl_tpu_torch import set_precision
from grl_tpu_torch.data import ClipDataset, ClipLoader, SyntheticVideoReID
from grl_tpu_torch.engine import Evaluator
from grl_tpu_torch.tools.profile_train_step import build_models

passes = int(sys.argv[1])
set_precision()
cnn, sia, _ = build_models("cuda", False, "fp32")
ev = Evaluator(cnn, sia, micro_batch=96, device="cuda")
rng = np.random.RandomState(0)
sizes = [30] * 20 + [10]
batches = [(rng.randint(0, 256, (n, 8, 256, 128, 3), np.uint8), np.arange(n), np.zeros(n)) for n in sizes]

def rows():
    with torch.inference_mode():
        return ev._extract_rows(batches, [], [])

ds = SyntheticVideoReID(num_train_ids=0, num_test_ids=150, tracklets_per_id=2, num_cams=2, frames_range=(8, 40),
                        height=256, width=128, seed=1)
loader = ClipLoader(ClipDataset(ds.gallery, 8, "rrs_test", 256, 128), batch_size=30, workers=8)

def run(fn):
    out = {"s": []}
    for i in range(passes + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = fn()
        out["checksum"] = float(feats.double().sum())  # the host read that ends the pass
        if i:
            out["s"].append(time.perf_counter() - t0)
    out["rows"] = int(feats.shape[0])
    return out

print(json.dumps({"rows": run(rows), "loader": run(lambda: ev.extract_features(loader)[0]),
                  "gpu": torch.cuda.get_device_name(0)}))
"""


def run(tree):
    proc = subprocess.run([sys.executable, "-c", RUN, str(PASSES)], cwd=tree, capture_output=True, text=True,
                          timeout=1200, env={**os.environ, "PYTHONPATH": str(tree)})
    if proc.returncode != 0:
        raise SystemExit(f"{tree}: exit {proc.returncode}\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    summary = {"card": smi, "passes": PASSES}
    with open(out / "runs.jsonl", "w") as f:
        for label in ("parent", "change", "change", "parent"):
            rec = {"tree": label, **run(trees[label])}
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
            for path in ("rows", "loader"):
                summary.setdefault(label, {}).setdefault(path, []).extend(rec[path]["s"])
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
