"""Probe host->device and device->host rates and per-dispatch latency
(counterpart of ``tools/probe_bandwidth.py``).

grl_tpu's probe read the rates of its TPU's host link and the round trip
of one dispatch, which shape every wall-clock number taken through it.
This asks the same of the card's host link with PyTorch:

- host->device and device->host rates from pageable and from pinned host
  memory, at grl_tpu's 16 MiB and at the two sizes the port moves most:
  one training batch (16 clips x 8 frames x 256x128x3 uint8, 12.6 MB) and
  one serve chunk at batch 32 (32 x 8 x 256x128x3 uint8, 25.2 MB). Each
  copy is timed alone on the host clock, the device synchronized before
  and after it; the median of ``REPS`` copies is reported;
- per-dispatch latency as grl_tpu measures it: 50 chained tiny ops
  (``x = x + 1`` on an 8x8 tensor) ending on one host read, per op;
- the round trip of one ``.item()`` of a device scalar, median of
  ``REPS``.

Runs on the card by default (it raises without one); ``--device cpu``
copies host to host without pinned buffers. Prints the card's name and
power limit, one line per reading and a JSON line of them all.

    python3 -m grl_tpu_torch.tools.probe_bandwidth [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from .. import resolve_device, set_precision
from ..utils.profiling import card_line, sync

# (name, bytes): grl_tpu's 16 MiB, one training batch and one serve chunk at batch 32
SIZES = (("16MiB", 16 << 20), ("train_batch_16", 16 * 8 * 256 * 128 * 3),
         ("serve_chunk_32", 32 * 8 * 256 * 128 * 3))
CHAINED = 50  # grl_tpu's chained tiny ops
REPS = 10  # copies (and .item() calls) per reading


def copy_seconds(copy, device, reps):
    """Median seconds of ``copy()`` over ``reps`` runs after one warm run,
    each alone between two synchronizations."""
    copy()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        copy()
        sync(device)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def probe(device="cuda", reps=REPS):
    """The readings as a dict: ``copies`` (per size, direction and host
    memory: bytes, median seconds, GB/s), ``per_dispatch_ms`` and
    ``item_ms``."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    float(torch.zeros(1024, device=device).sum())  # the first touch pays the context's set-up
    out = {"device": str(device), "init_s": time.perf_counter() - t0, "copies": {}}
    kinds = ("pageable", "pinned") if device.type == "cuda" else ("pageable",)
    for name, nbytes in SIZES:
        host = torch.from_numpy(np.random.RandomState(0).randint(0, 256, nbytes, np.uint8))
        dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        for kind in kinds:
            src = host.pin_memory() if kind == "pinned" else host
            back = torch.empty(nbytes, dtype=torch.uint8, pin_memory=kind == "pinned")
            for direction, copy in (("h2d", lambda: dev.copy_(src, non_blocking=kind == "pinned")),
                                    ("d2h", lambda: back.copy_(dev, non_blocking=kind == "pinned"))):
                sec = copy_seconds(copy, device, reps)
                out["copies"][f"{name}_{direction}_{kind}"] = {"bytes": nbytes, "s": sec, "GB_per_s": nbytes / sec / 1e9}
            if not torch.equal(back[:4096], host[:4096]):
                raise RuntimeError(f"{name} {kind}: the bytes did not come back as they went")

    x = torch.zeros((8, 8), device=device)
    for _ in range(CHAINED):  # the add's first launch loads its kernel
        x = x + 1.0
    x = torch.zeros((8, 8), device=device)
    float(x.sum())
    sync(device)
    t0 = time.perf_counter()
    for _ in range(CHAINED):
        x = x + 1.0
    total = float(x.sum())  # the one host read that ends the chain
    out["per_dispatch_ms"] = (time.perf_counter() - t0) / CHAINED * 1e3
    if total != 64.0 * CHAINED:
        raise RuntimeError(f"chained ops summed to {total}")

    s = torch.ones((), device=device)
    s.item()
    times = []
    for _ in range(reps):
        sync(device)
        t0 = time.perf_counter()
        s.item()
        times.append(time.perf_counter() - t0)
    out["item_ms"] = statistics.median(times) * 1e3
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu copies host to host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_precision()
    print(f"card: {card_line(device)}", flush=True)
    res = probe(device, REPS)
    print(f"init: {res['init_s']:.3f}s", flush=True)
    for key, c in res["copies"].items():
        print(f"{key}: {c['GB_per_s']:.2f} GB/s ({c['bytes']} B in {c['s'] * 1e3:.3f} ms)", flush=True)
    print(f"per-dispatch: {res['per_dispatch_ms']:.4f} ms ({CHAINED} chained tiny ops, one host read)")
    print(f"item round trip: {res['item_ms']:.4f} ms")
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
