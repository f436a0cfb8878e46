"""Headline benchmark of the port (counterpart of the root ``bench.py``):
MARS dense-eval clip-descriptor throughput on one card.

    python -m grl_tpu_torch.bench [--device cuda]

Measures the hot path of the evaluation stack (the "MARS clip
features/sec/chip" of BASELINE.json): the full-size ResNet-50 + GCE + TRL +
attention pooling producing the 6144-d descriptor for 8-frame 256x128
clips, bf16 compute, on the card, through ``make_descriptor_fn`` as the
``Evaluator`` runs it (eager, not graph-captured). Also times the
MARS-scale evaluation tail (1980x11310 cosine distmat + the device CMC/mAP
protocol, 6144-d) and reports it as ``gallery_queries_per_sec``, the
second throughput of BASELINE.json's metric line.

Prints ONE JSON line with bench.py's keys:
  {"metric": ..., "value": N, "unit": "clips/s", "vs_baseline": N,
   "gallery_queries_per_sec": N, ...}

The reference publishes no throughput numbers (BASELINE.md: "none
recorded"), so ``vs_baseline`` divides by the reference's own dense-eval
descriptor rate on one host CPU core, measured by
``tools/measure_reference_cpu.py`` and recorded in bench.py: a different
device class than the card. ``vs_nominal_100`` keeps bench.py's nominal
100 clips/s anchor. Runs on the card; ``--device cpu`` runs on the host.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import models, resolve_device, set_precision
from .engine import make_descriptor_fn, metrics
from .engine.evaluator import cosine_distance

# tools/measure_reference_cpu.py, 2026-08-17 (two runs: 0.533 / 0.525
# clips/s; the reference on torch 2.13, one host CPU core), as bench.py
# records it
REF_CPU_MEASURED_CLIPS_PER_SEC = 0.53
REF_NOMINAL_CLIPS_PER_SEC = 100.0  # rounds 1-2 continuity anchor
# bench.py's width; chip_smoke.py's ``bench`` phase sweeps 32-192 on the H100
# (PERF.md §5)
MICRO_BATCH = 96
SEQ_LEN = 8
H, W = 256, 128
# the MARS test split: 1980 queries, 9330 more gallery tracklets, 6144-d
GALLERY_Q, GALLERY_EXTRA_G, GALLERY_DIM = 1980, 9330, 6144


def build_models(device):
    """bench.py's models: ``resnet50_grl`` (seed 0) and the ``siamese`` head
    (2048 -> 512, seed 1), bf16 compute, eval mode, on ``device``."""
    cnn = models.create("resnet50_grl", device=device, seed=0, compute_dtype=torch.bfloat16)
    siamese = models.create("siamese", device=device, seed=1, input_num=cnn.num_feat, output_num=512,
                            compute_dtype=torch.bfloat16)
    return cnn.eval(), siamese.eval()


def descriptor_clips_per_sec(batch, device, modules=None):
    """Warm clips/s of the descriptor at micro-batch ``batch``: bench.py's
    seeded uint8 clips, ``timed(1)`` and ``timed(2)`` to warm, then
    ``timed(10)``; each window chains the outputs into one scalar and ends
    on its host read."""
    cnn, siamese = modules if modules is not None else build_models(device)
    describe = make_descriptor_fn(cnn, siamese)
    clips = torch.from_numpy(
        np.random.RandomState(0).randint(0, 256, (batch, SEQ_LEN, H, W, 3), np.uint8)).to(device)

    def timed(iters):
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(iters):
            acc = acc + describe(clips).sum()
        float(acc)
        return time.perf_counter() - t0

    with torch.inference_mode():
        timed(1)  # cuDNN's set-up, the allocator
        timed(2)  # steady-state clocks
        dt = timed(10)
    return batch * 10 / dt


def gallery_ids(q, extra_g):
    """bench.py's ids and cameras, drawn from ``RandomState(0)`` in its
    order: ``(q_pids, g_pids, q_cams, g_cams)``, the gallery being the
    queries and ``extra_g`` more items."""
    rng = np.random.RandomState(0)
    q_pids = rng.randint(0, q, q)
    g_pids = np.concatenate([q_pids, rng.randint(0, q, extra_g)])
    q_cams = rng.randint(0, 6, q)
    g_cams = np.concatenate([q_cams, rng.randint(0, 6, extra_g)])
    return q_pids, g_pids, q_cams, g_cams


def gallery_tail(qf, gf, q_pids, g_pids, q_cams, g_cams):
    """The evaluation tail: cosine distances, then the device protocol ->
    ``(cmc_curve, mAP)`` on the host."""
    return metrics.evaluate_device(cosine_distance(qf, gf), q_pids, g_pids, q_cams, g_cams)


def gallery_tail_queries_per_sec(device):
    """MARS-scale eval tail, warm: queries per second of one
    ``gallery_tail`` over unit rows drawn on the device from a seeded
    generator (the tail's cost does not depend on their values). The
    protocol returns the CMC curve and mAP to the host, which ends the
    window on a real sync."""
    q, extra_g, dim = GALLERY_Q, GALLERY_EXTRA_G, GALLERY_DIM
    gen = torch.Generator(device=device).manual_seed(0)
    qf = torch.randn((q, dim), generator=gen, device=device)
    qf = qf / qf.norm(dim=1, keepdim=True)
    gfr = torch.randn((extra_g, dim), generator=gen, device=device)
    gfr = gfr / gfr.norm(dim=1, keepdim=True)
    gf = torch.cat([qf, gfr])  # reference protocol: gallery = query U gallery
    ids = gallery_ids(q, extra_g)
    with torch.inference_mode():
        gallery_tail(qf, gf, *ids)  # warm
        t0 = time.perf_counter()
        gallery_tail(qf, gf, *ids)
        dt = time.perf_counter() - t0
    return q / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_precision()
    clips_per_sec = descriptor_clips_per_sec(MICRO_BATCH, device)
    queries_per_sec = gallery_tail_queries_per_sec(device)
    line = {
        "metric": "mars_clip_features_per_sec_per_chip",
        "value": round(clips_per_sec, 2),
        "unit": "clips/s",
        "vs_baseline": round(clips_per_sec / REF_CPU_MEASURED_CLIPS_PER_SEC, 1),
        "baseline": "reference dense-eval descriptor path, "
                    f"{REF_CPU_MEASURED_CLIPS_PER_SEC} clips/s cpu-measured on one host core "
                    "(tools/measure_reference_cpu.py; 1 H100 vs 1 host core)",
        "vs_nominal_100": round(clips_per_sec / REF_NOMINAL_CLIPS_PER_SEC, 3),
        "gallery_queries_per_sec": round(queries_per_sec, 1),
        "gallery_scale": f"MARS {GALLERY_Q}x{GALLERY_Q + GALLERY_EXTRA_G}, {GALLERY_DIM}-d, "
                         "distmat + device CMC/mAP, warm",
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
