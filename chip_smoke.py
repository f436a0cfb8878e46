#!/usr/bin/env python3
"""Drive grl_tpu_torch's main path on one CUDA card and check its kernels.

    python3 chip_smoke.py

The main path is dense evaluation with k-reciprocal re-ranking at the full
width of ``resnet50_grl`` (ResNet-50 trunk with last stride 1, GCE,
bidirectional TRL, BN-neck, Siamese attention pooling, 6144-d
descriptor), with seeded random weights. Phases:

1. the card: name, and name + power limit as nvidia-smi reports them;
2. build every kernel from ``grl_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch version at the main path's
   shapes and at the edges of its design (ragged k, k below one stage,
   k = 0, tile multiples and one above, more tiles than resident blocks,
   row-strided operands, V-like sparse rows), then timed at the MARS shape
   beside its plain version, one library call computing the same function,
   its data-sheet bound and its instruction-issue bound, with the SM clock
   and power draw sampled while it runs;
4. the full-width descriptor on the card against the same model on the CPU
   (its warm rates are ``descriptor_rates``, phase 17);
5. the slice: ``Evaluator(..., rerank=True).evaluate`` over a synthetic
   catalog at 256x128, with every kernel's launch count zeroed just
   before and read just after; the re-ranked distance matrix is checked
   against the same re-ranking with the plain min-sum;
6. re-ranking and the device protocol at MARS scale (1980 queries, 11310
   query ∪ gallery items, 6144-d features);
7. ``train_check``: one full-width GRL training step (``resnet50_grl`` +
   ``Siamese(2048, 512)`` + ``SiameseVideo(2048)``, 2 pairs of 8-frame
   256x128 clips, augmentation off) on the card against the same step on
   the CPU: loss terms, every parameter's update, the luts and the BN
   running statistics;
8. ``train``: ``Trainer.train`` at the reference batch (16 clips = 8
   anchor/positive pairs x 8 frames x 256x128) over a synthetic catalog
   with ``ClipLoader`` + ``RandomPairSampler``, augmentation on the card,
   with every kernel's launch count zeroed just before;
9. ``train_eval``: ``Evaluator(rerank=True).evaluate`` on the trained
   modules over the catalog's test split, as ``grl_tpu/cli/train.py`` does
   at its eval epochs; the launch counts are read after it (the min-plus
   kernel runs in the re-ranking) and the re-ranked distance matrix is
   checked against the same re-ranking with the plain min-sum;
10. ``cli_train``: ``grl_tpu_torch.cli.train.main`` in this process, at
    full width over the synthetic catalog (32 train ids, 64x32 frames),
    batch 16, 2 epochs, ``--rerank 1``: launch counts zeroed before and
    read after (the final epoch's evaluation re-ranks on the min-plus
    kernel); the trainer's warm step, the checkpoint's bytes, the main
    thread's wait in ``AsyncCheckpointer.save`` and the writer's seconds;
    then a copy of the final state steps back to back at the run's batch
    (CUDA-event ms per step, kernel time under ``torch.profiler``);
11. ``cli_resume``: ``checkpoint.npz`` loaded into a fresh ``TrainState``
    on the card and on the CPU, each leaf bit-equal to the state
    ``cli_train`` ended with; then ``--resume ... --epochs 3`` trains
    exactly one epoch;
12. ``cli_evaluate``: ``grl_tpu_torch.cli.evaluate.main`` on the best
    checkpoint with ``--rerank 1 --save-distmat``: the kernel launched, the
    saved distance matrix finite and equal to the evaluator's, which is
    checked against the same re-ranking with the plain min-sum;
13. ``cli_mars``: a small dataset in MARS's on-disk layout (256x128 JPEGs
    written by ``tools.make_fake_mars`` at ``FAKE_SIZES``, its junk
    tracklet included), ``cli.train -d mars`` for one epoch and
    ``cli.evaluate -d mars --rerank 1``, decoding through
    ``data/jpeg.py`` (the native routine where it builds, PIL otherwise);
14. ``rerank_staged``: re-ranking of random unit 6144-d features at n =
    19960 (1980 queries, 17980 query ∪ gallery items), past the staged
    builder's cut at 16384: the staged builder (one kernel launch per
    8192-row slab), the one-program builder (one launch of the selection
    kernel, which the staged runs do not launch) and the staged builder
    with the plain min-sum agree; seconds and peak memory of each;
15. ``serve``: ``cli.extract export-model`` of ``cli_train``'s checkpoint
    at full width (batch 32, 8 frames, 256x128), then ``serve --listen
    unix:`` in this process driven by ``grl_tpu_torch.client.ServeClient``:
    ping, describe of 64 clips against the same modules on the card, add
    of 256 rows (index of 11310), plain and re-ranked rank, two concurrent
    describe clients (packed dispatches), stats, save, shutdown; a second
    daemon at capacity 16384 takes the staged re-ranking route. Both
    routes' answers are held against ``re_ranking`` on the unpadded index
    and against their own geometry with the plain min-sum;
16. ``extract_cli``: ``cli.extract features`` (query and gallery) on
    ``cli_train``'s checkpoint, then ``rank --rerank``;
17. ``model_bf16`` (after the slice): the full-width descriptor with
    ``compute_dtype=torch.bfloat16`` against the card's fp32 descriptor
    of the same weights and against the same bf16 modules on the CPU at 2
    clips (per-row cosine of the pre-neck features, as they are and less
    the batch's mean, held to ``BF16_COSINE_MIN``; the descriptor's
    per-segment cosine and max abs printed beside); cuDNN's
    BatchNorm on a bf16 input in train mode (bf16 out, fp32 unbiased
    running statistics); ``descriptor_rates``: warm ms, clips/s and peak
    memory at micro-batch 32 and 96 of fp32, fp32 with TF32 on, bf16 and
    bf16 with the modules in channels_last, fp32 first and last;
18. ``train_bf16`` (after ``train_eval``): ``Trainer.train`` at batch 16
    with the ``cli.train --bf16`` modules (warm step ms, peak memory, a
    profile); ``precision_steps``: one full-width step in bf16, fp32 and
    fp32 with TF32 on against an fp64 step of the same weights, and the
    step ms at batch 16 of fp32, TF32, bf16 and bf16 channels_last; the
    ``tf32`` line gathers the TF32 numbers;
19. ``cli_bf16`` (last): ``cli.train --bf16 --rerank 1`` for one epoch and
    ``cli.evaluate --bf16 --rerank 1`` on its checkpoint (the min-plus
    kernel launched, the re-ranking equal to the plain min-sum's), then
    ``export-model --bf16`` at full width and a daemon's ``describe``
    against the in-process bf16 descriptor, with the artifact's bytes;
20. ``flow`` (after ``cli_mars``), the optical-flow configuration: an
    iLIDS-VID layout with flow companions under ``build/chip_flow/`` (24
    ids x 2 cameras x 24 frames, 128x64 JPEGs, resized to 256x128);
    ``flow_cli``: ``cli.train --use-flow -b 16 --seq_len 8 --epochs 1
    --rerank 1`` at full width (a 6-channel trunk; the warm step of its
    state at 256x128x6, the flow loader's clips and JPEGs per second),
    ``cli.evaluate --use-flow --rerank 1 --visual 1 --save-distmat``
    under ``torch.profiler`` (the kernel launched and named in its
    Chrome trace, the re-ranking equal to the plain min-sum's, one strip
    directory per query), then ``--visual-from`` on the npz (the same
    rank-1, mAP and strips, no launch); ``flow_serve``: ``features
    --use-flow`` and ``rank --rerank`` (one launch), ``export-model
    --use-flow`` at batch 32 x 8 x 256x128 x 6, a daemon's ``describe``
    of 32 flow clips against the modules, a 3-channel clip refused;
    ``flow_models``: the 6-channel ``resnet50_grl`` descriptor,
    ``ResNetBaseline`` and ``TwoStreamBaseline`` card against CPU on 2
    clips with their warm ms per 32 clips, and ``visualize_attention``'s
    masks card against CPU;
21. ``data_parallel`` (after ``train_eval``), in a child process that forms
    a one-rank NCCL group on the card (``parallel.launch``), so NCCL's
    set-up and teardown never touch this process; the group path is forced
    at world size 1 (global BatchNorm, the gather after the CNN, the
    gradients' sum, the broadcast from rank 0, the collective stop):
    ``dp_step``: one full-width step at batch 16 (8 pairs x 8 x 256x128)
    from one state, the group step against the plain step, held to
    ``train_check``'s fp32 tolerance; ``dp_bn``: ``GlobalBatchNorm`` (on
    the card, torch's fused BatchNorm ops) against ``BatchNorm2d`` at the
    trunk's first BatchNorm (128 x 64 x 128 x 64), fp32 and bf16 inputs:
    output, gradients and running statistics relative to the reference's
    largest value (1e-4 fp32, 2^-6 bf16), and the ms of each beside the
    two-pass Function's; ``dp_train``: ``Trainer.train`` for
    3 steps under the group and the plain trainer beside it, CUDA-event ms
    of each step; ``dp_evaluate``: the striped ``Evaluator.evaluate
    (rerank=True)`` of the slice's catalog under the group against the
    one-card ``Evaluator`` (rank-1, mAP, distances within 1e-5), the
    min-plus kernel's launches counted around it. Then, in this process,
    ``dp_cli``: ``cli.train --devices 2`` on a one-card machine runs on one
    card (grl_tpu's cap) and says so;
22. ``rerank_sharded`` and ``eval_sharded`` (after ``rerank_staged``), on
    two gloo ranks that this script spawns on the one card (NCCL refuses
    two ranks on one device; gloo takes CUDA tensors as they are):
    ``rerank_sharded``: ``re_ranking(mesh=)``, the row-sharded staged
    builder, on ``rerank_staged``'s features (n = 19960: 9980 rows of V
    per rank, slabs of 8192 and 1788 rows), its result held to the
    one-card staged builder's, each rank's peak memory beside the one-card
    staged peak of the same run, each rank's launches and slab shapes,
    each slab shape's kernel output held to the plain min-sum;
    ``eval_sharded``: the slice's catalog at full width striped over the
    two ranks and re-ranked through the sharded tail (``Evaluator(mesh=)``:
    sharded distances, the row-sharded builder, the sharded protocol)
    against the one-card ``Evaluator``;
23. ``serve_devices`` (in ``serve``): ``serve --devices 2`` on the staged
    daemon's artifact, index and capacity: on a one-card machine one rank
    on the staged route, which says so; its re-ranked answers are the
    staged daemon's.

24. ``fake_trees`` (after ``cli_mars``): ``tools.make_fake_duke`` and
    ``tools.make_fake_mars`` write a DukeMTMC-VideoReID and a MARS tree of
    256x128 JPEGs under ``build/chip_fake/`` (``FAKE_SIZES``: 16 train and
    8 test ids, 2 cameras, 8-16 frames), each tree's file count and write
    seconds;
25. ``prepare_real_data``: the tool's ``main`` on both trees: "catalog ok",
    the split-cache JSON files written, every spot-decoded frame 256x128x3,
    the recipe naming ``grl_tpu_torch``, the decode route and the native
    routine's build error;
26. ``cli_duke``: on the Duke tree, ``cli.train -d duke -b 16 --epochs 1``
    at full width, then ``cli.evaluate -d duke --rerank 1`` on its
    checkpoint, with the launch counts zeroed before the evaluation and read
    after it: the min-plus kernel launched, the distance matrix finite, the
    re-ranking equal to the plain min-sum's;
27. ``profile``: ``tools.profile_train_step`` in this process for the bf16
    training step at batch 16 and the bf16 descriptor at micro-batch 96, 3
    traced steps each, with ``--roofline convolution``: the kernel
    categories sum to the kernel total, ``--report-only`` on the saved
    trace prints the same tables, a convolution row carries the profiler's
    flops;
28. ``entry`` (after the slice): ``grl_tpu_torch.entry.entry()``, the
    full-size eval-mode forward on its zero (2, 8, 256, 128, 3) clip pair:
    output shapes, finite values, warm ms;
29. ``dryrun`` (after ``rerank_sharded``): ``entry.dryrun_multichip(1)``
    (one NCCL rank) and ``(2)`` (two gloo ranks sharing the card): each
    rank's group step and sharded tail finite, its min-plus launches, its
    re-ranking against the one-process builder with the plain min-sum;
30. ``learning_equivalence`` (last): one fp32 seed of
    ``tools.learning_equivalence`` at the recorded runs' schedule
    (``cli.train -d mars`` in a subprocess on a fake-MARS tree of 256x128
    JPEGs under ``build/chip_leq/``): the first-step loss within
    ``LEQ_FIRST_LOSS``, evaluations at epochs 4 and 5, a finite final mAP,
    printed beside the recorded runs' medians with the seed's seconds.

31. ``bench`` (after ``model_bf16``): ``python -m grl_tpu_torch.bench`` in a
    subprocess, as a user runs it: one JSON line with the root bench.py's
    eight keys, both rates finite and above 0; then ``bench_sweep``, the
    bf16 descriptor's clips/s and peak memory at micro-batch 32, 64, 96,
    128 and 192. ``profile_op_links`` (in ``profile``): the ops around the
    launches of the descriptor's clamp and BatchNorm kernels.

32. ``probes`` (after the slice): ``Evaluator.describe_clips`` at full
    width on the slice's fp32 modules through the rrs_test row path (a
    catalog's gallery in loader batches of 43 clips: chunks of 32 and 11,
    padded to 32 and 16), each chunk's valid rows held to the descriptor of
    the same clips unpadded within ``DESCRIBE_TOL``; then the four probe and
    sweep tools' functions at reduced repeats (their CLIs keep grl_tpu's):
    ``probe_bandwidth`` (host<->device rates, pageable and pinned, at 16 MiB,
    a training batch and a serve chunk; per-dispatch latency; ``.item()``),
    ``probe_int8`` (int8 and bf16 products at 8192^3, the 3x3 conv at
    layer3's shape, the im2col fallback; the int8 product and the im2col
    exact; the int8 conv's rejection is a result), ``sweep_compiler_options``
    (the bf16 descriptor at 96 under ``PROBE_SWEEP``: the default,
    ``cudnn.benchmark`` in a child process from an empty cuDNN plan cache,
    channels_last and a CUDA graph, each within 1e-2 of the default) and
    ``sweep_train_compiler_options`` (the bf16 step at batch 16 under
    ``PROBE_TRAIN_SWEEP``: the default and channels_last, then fp32 and
    fp32 under deterministic kernels in a child). No kernel of the port is on this path: the launch counts are
    read around it and logged.

In ``serve``, ``flow_serve`` and ``cli_bf16`` the artifact, which no
longer keeps its zero example input, is held against the same program
saved with it: bytes of each, answers bit-equal. Its call on the card
replays one CUDA graph: on two different batches in a row it is held to
the eager program within ``GRAPH_TOL`` (expected bit-equal), the first
answer must survive the second call, ``replays`` must count both, and over
each daemon's requests the graph's replays must equal the coalescer's
dispatches; the load seconds, the graph pool's bytes and the program's op
nodes are logged.

The kernel is also timed at the serve route's shape (32 x 11598 x 11598),
at one slab of the staged builder (1980 x 8192 x 19960) and at the short
slab that ends each rank's rows in ``rerank_sharded`` (1980 x 1788 x
19960).

``nearest`` (after phase 3): the selection kernel held index for index to
the stable argsort's first k columns on uniform, clustered, lattice-tied
and padded rows (k = 1, 6, 21, 32, 41 and 100; n from 13 to 32768; a row
stride past n), then timed at the serve route's (11598²) and MARS's (13290²)
re-ranking shapes on clustered distances beside its bound (one read of the
matrix), the plain version and ``torch.topk`` on unique int64 keys. The
``serve`` phase counts its launches in the padded daemon's warm-up and per
re-ranked request (padded route 1, staged route 0), ``rerank_staged`` per
run (one-program builder 1, staged builder 0).

The script runs under the CLIs' precision policy
(``grl_tpu_torch.set_precision``: TF32 off in cuDNN and cuBLAS, bf16
products reduced in fp32) except inside the phases that measure TF32: the
comparisons hold fp32 on the card against fp32 on the CPU or in plain
PyTorch. The CLIs set that policy themselves: before each CLI ``main``
(and the serve daemons) the script turns the flags on, and checks that
they are off inside the run and after it.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failed phase raises, and the script
exits non-zero without that last line; without a CUDA card it exits 1
before any phase.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import faulthandler
import importlib.util
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from grl_tpu_torch import bench
from grl_tpu_torch import entry as hooks
from grl_tpu_torch import models, ops, parallel, precision_flags, set_precision, set_precision_flags
from grl_tpu_torch.cli import evaluate as cli_evaluate
from grl_tpu_torch.cli import extract as cli_extract
from grl_tpu_torch.cli import train as cli_train
from grl_tpu_torch.client import ServeClient, ServeError
from grl_tpu_torch.data import ClipDataset, ClipLoader, RandomPairSampler, SyntheticVideoReID, get_data, normalize
from grl_tpu_torch.data import jpeg
from grl_tpu_torch.data.sampling import dense_indices
from grl_tpu_torch.engine import (Evaluator, Trainer, grl_loss_fn, init_train_state,
                                  make_descriptor_fn, make_train_step, metrics, step_decay_lr)
from grl_tpu_torch.engine.evaluator import _euclidean, cosine_distance, rerank_columns, rerank_inputs
from grl_tpu_torch.engine import rerank as rerank_mod
from grl_tpu_torch.engine.rerank import re_ranking, re_ranking_padded
from grl_tpu_torch.nn import GlobalBatchNorm, convert_global_batchnorm
from grl_tpu_torch.nn.norm import _GlobalBatchNormFn
from grl_tpu_torch.ops.build import BUILD_INFO
from grl_tpu_torch.ops.minplus import _config as minplus_config
from grl_tpu_torch.ops.minplus import _lib as build_minplus
from grl_tpu_torch.ops.nearest import _lib as build_nearest
from grl_tpu_torch.tools import learning_equivalence as leq
from grl_tpu_torch.tools import make_fake_duke, make_fake_mars, prepare_real_data, profile_train_step
from grl_tpu_torch.tools import probe_bandwidth, probe_int8, sweep_compiler_options, sweep_train_compiler_options
from grl_tpu_torch.utils import AsyncCheckpointer, load_train_state, serialization
# the card's peaks (H100 SXM data sheet): dense bf16 on the tensor cores,
# fp32 outside them, and device memory bandwidth
from grl_tpu_torch.utils.profiling import PEAK_BF16_OPS, PEAK_BYTES, PEAK_FP32_OPS

# the MARS test split: 1980 queries, 11310 = 1980 + 9330 query ∪ gallery
MARS_Q, MARS_EXTRA_G = 1980, 9330
MARS_N = MARS_Q + MARS_Q + MARS_EXTRA_G  # 13290 rows of V
# the staged re-ranking: 1980 queries, 17980 = 1980 + 16000 query ∪ gallery
# items, n = 19960 above the staged builder's cut at 16384
STAGED_Q, STAGED_EXTRA_G = 1980, 16000
STAGED_N = STAGED_Q + STAGED_Q + STAGED_EXTRA_G
STAGED_SLAB_SHAPE = (STAGED_Q, 8192, STAGED_N)  # one min-plus slab of its loop
STAGED_SEED = 19960  # its features' generator, which the sharded phase's ranks seed alike
# the sharded phases: two gloo ranks on one card; each rank owns 9980 rows of
# V at n = 19960, two min-plus slabs (8192 and 1788 rows)
SHARDED_RANKS = 2
SHARDED_TAIL_SLAB_SHAPE = (STAGED_Q, STAGED_N // SHARDED_RANKS - 8192, STAGED_N)
# the serve daemon: 16 re-ranked queries padded to the artifact's 32-clip
# batch, an index of MARS's 11310 items (11054 at start + 256 enrolled) in a
# buffer of capacity + one 256-row enrollment block
SERVE = {"batch": 32, "seq_len": 8, "frame": (256, 128), "gallery": 11054, "add": 256,
         "capacity": 11310, "staged_capacity": 16384, "queries": 16, "clips": 64, "dim": 6144}
SERVE_N = SERVE["batch"] + SERVE["capacity"] + 256
SERVE_SHAPE = (SERVE["batch"], SERVE_N, SERVE_N)  # V[:q_pad] x V
KERNEL_TOL = 1e-5  # fp32, sums of row-normalized values (≤ 1) in another order
MODEL_TOL = 1e-3   # fp32 card vs fp32 CPU through ~60 conv layers
# the full-width bf16 model against fp32, and bf16 on the card against
# bf16 on the CPU: the lowest per-row cosine of the TRL features that enter
# the BN-neck, as they are ("uncentred") and each less its batch's mean
# feature ("centred"). At random weights every clip's features are nearly
# alike, so the uncentred cosine reads near 1 whatever the clip, and the
# centred one reads what tells clips apart (a swapped clip reads -1).
# Card against CPU, where both round alike, both are held (readings on
# NVIDIA H100 80GB HBM3 over four draws of clips: centred 0.714-0.986,
# uncentred 0.9986-0.9998). Against fp32 the clip-to-clip differences are
# below bf16's rounding (centred -0.86 to 0.61, also with clips of
# distinct content), so only the uncentred cosine is held, against gross
# faults (readings 0.986-0.997). The casts themselves are
# held by the CPU tests against grl_tpu. The descriptor's own cosines and
# max abs are printed beside, unchecked: the BN-neck scales its input's
# error up by the printed neck gain
BF16_COSINE_MIN = {"vs_fp32": {"uncentred": 0.98},
                   "card_vs_cpu": {"centred": 0.5, "uncentred": 0.998}}
# One full-width training step, card against CPU (TF32 off; the measures
# are those of ``compare_steps``). In fp64 both must compute the same
# function: each loss term, each parameter's update, the BN statistics and
# the luts agree to rounding. In fp32 the step is ill-conditioned at random
# weights: against the fp64 step each device's fp32 updates are off by a
# few percent (L2 over all parameters) and single leaves by ~10 %, so the
# fp32 limits bound the loss terms, all updates together, BN statistics and
# luts, with the card's and the CPU's distance from fp64 printed beside.
# (fp64's worst leaf is a bias in front of a BN, whose update is rounding:
# 8.4e-7 of it on NVIDIA H100 80GB HBM3, 700 W; every other leaf < 1e-8)
TRAIN_TOL_FP64 = {"loss": 1e-9, "leaf": 1e-5, "bn": 1e-9, "lut": 1e-9}
TRAIN_TOL_FP32 = {"loss": 1e-3, "all_l2": 0.1, "bn": 5e-3, "lut": 5e-4}
TRAIN_LR = step_decay_lr(1e-3, 0)  # the reference's base lr, epoch 0
FRAME = (256, 128)  # the reference's clip frames (config.py)
# the CLI phases' working directories (``.gitignore`` lists build/)
ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"
CLI_DIR = BUILD / "chip_cli"
SHARDED_DIR = BUILD / "chip_sharded"
SYNTH_IDS = 32  # train ids of the CLI phases' synthetic catalog (= the checkpoint's classes)
CLI_TRAIN = ["-d", "synthetic", "--synthetic-ids", str(SYNTH_IDS), "-b", "16", "--rerank", "1",
             "--logs-dir", str(CLI_DIR)]
SERVE_DIR = BUILD / "chip_serve"
# the flow phase: an iLIDS-VID layout with flow companions, 24 ids x 2
# cameras x 24 frames of 128x64 JPEGs, which the loader resizes to 256x128
FLOW_DIR, FLOW_RUN = BUILD / "chip_flow", BUILD / "chip_flow_run"
FLOW_IDS, FLOW_FRAMES = 24, 24
FLOW_FRAME = (256, 128)
# the fake MARS and Duke trees (``tools.make_fake_mars``/``make_fake_duke``):
# 16 train ids and 8 test ids over 2 cameras, 8-16 frames a tracklet
FAKE_SIZES = dict(train_ids=16, test_ids=8, cams=2, frames_range=(8, 16))
FAKE_DIR, DUKE_RUN, PROFILE_DIR = BUILD / "chip_fake", BUILD / "chip_duke_run", BUILD / "chip_profile"
# the profile phase: the bf16 training step at the reference batch and the
# bf16 descriptor at bench.py's micro-batch, 3 traced steps each
PROFILES = (("train", 16), ("describe", 96))
# the learning check: one fp32 seed at the recorded runs' schedule
# (docs/leq_r5/summary.json); every recorded first-step loss lies in
# 20.8-21.4, median 21.1, and the port's must lie within 1.0 of that median
LEQ_DIR = BUILD / "chip_leq"
LEQ_ARGS = ["--seeds", "0", "--epochs", "6", "--lr-step", "2"]
LEQ_FIRST_LOSS = (20.1, 22.1)
DRYRUN_RANKS = (1, 2)  # dryrun_multichip's group sizes: one NCCL rank, two gloo ranks sharing the card
# parameters no loss term reaches: they move by weight decay alone
UNREACHED = ("siamese.featV.", "siamese.featV_bn.", "siamese_uncorr.classifierlinear.",
             "siamese_uncorr.classifierBN.")


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi(query="name,power.limit", units=True):
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, during=None):
    """Mean device time of ``fn()`` over ``reps`` launches after one warm-up;
    ``during()``, if given, runs on the host while the launches execute."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sampled = during() if during else None
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    return (ms, sampled) if during else ms


def device_profile(run, top=12):
    """Kernel time of ``run()`` by kernel (``torch.profiler``), and the
    wall time of the profiled run."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an op's row repeats the time of the kernels it launched
    rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"kernel_ms_total": sum(e.self_device_time_total for e in rows) / 1e3,
            "profiled_wall_ms": wall_ms,
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count] for e in rows[:top]]}


def row_normalized(rows, k, gen, padded=False):
    """Row-normalized uniform rows; ``padded`` puts them in 16-byte aligned
    rows, as re-ranking builds V (``ops.padded_empty``)."""
    x = torch.rand(rows, k, device="cuda", generator=gen)
    x /= x.sum(dim=1, keepdim=True)
    return ops.padded_empty(rows, k, "cuda").copy_(x) if padded else x


def sparse_rows(rows, k, nnz, gen):
    """V-like rows: ~nnz positive entries out of k, row-normalized."""
    keep = torch.rand(rows, k, device="cuda", generator=gen) < nnz / k
    x = torch.rand(rows, k, device="cuda", generator=gen) * keep
    x[:, 0] += 1e-3  # no empty row
    return x / x.sum(dim=1, keepdim=True)


def kernel_cases(gen):
    """(what, a, b) at the main path's shapes and the design's edges."""
    tile, slots = minplus_config(torch.device("cuda"))
    many_m = -(-(slots + slots // 4) // 8) * tile[0] - 5  # > slots tiles with n = 8 tile columns
    shapes = [(37, 150, 300), (5, 9, 17), (129, 257, 1000), (256, MARS_N, MARS_N),
              (37, 150, 1001), (40, 70, 5), (9, 300, 0),
              (tile[0], tile[1], 300), (tile[0] + 1, tile[1] + 1, 300),
              (many_m, 8 * tile[1] - 3, 64), (many_m, 8 * tile[1] - 3, 1001)]
    for m, n, k in shapes:
        yield f"{m}x{n}x{k}", row_normalized(m, k, gen), row_normalized(n, k, gen)
    wide_a, wide_b = row_normalized(70, 1003, gen), row_normalized(150, 1003, gen)
    yield "row-strided 70x147x999", wide_a[:, 1:1000], wide_b[3:, :999]
    v = sparse_rows(2000, 2000, 30, gen)
    yield "V-like 300x2000x2000, ~30 of 2000 non-zero", v[:300], v


def phase_kernels(gen):
    """Kernel against plain at the main path's shapes and the design's
    edges; then timings at MARS."""
    worst = 0.0
    for what, a, b in kernel_cases(gen):
        out = ops.minplus(a, b)
        torch.cuda.synchronize()
        err = float((out - ops.minplus_plain(a, b)).abs().max()) if out.numel() else 0.0
        log("kernel_check", kernel="minplus", case=what, max_abs_err=err)
        check(err <= KERNEL_TOL, f"minplus {what} max abs err {err}")
        if a.shape[1] == 0:
            check(bool((out == 0).all()), "minplus with k = 0 is not all zeros")
        worst = max(worst, err)

    m, n, k = MARS_Q, MARS_N, MARS_N
    a, b = row_normalized(m, k, gen, padded=True), row_normalized(n, k, gen, padded=True)
    out = ops.minplus(a, b)
    torch.cuda.synchronize()
    kernel_ms, (sm_mhz, power_w) = cuda_ms(lambda: ops.minplus(a, b), reps=10,
                                           during=lambda: nvidia_smi("clocks.sm,power.draw", units=False).split(", "))
    # the same call on contiguous rows of 13290 floats, which the wrapper
    # first copies into 16-byte aligned rows
    a_dense, b_dense = a.contiguous(), b.contiguous()
    dense_ms = cuda_ms(lambda: ops.minplus(a_dense, b_dense), reps=3)
    del a_dense, b_dense
    plain = ops.minplus_plain(a, b)
    plain_ms = cuda_ms(lambda: ops.minplus_plain(a, b), reps=1)
    err = float((out - plain).abs().max())
    check(err <= KERNEL_TOL, f"minplus at MARS shape max abs err {err}")
    worst = max(worst, err)
    # Σ_t min(a, b) = (Σa + Σb − Σ|a − b|) / 2: cdist(p=1) does the same pair work
    library_ms = cuda_ms(lambda: torch.cdist(a, b, p=1), reps=1)
    via_cdist = (a.sum(1)[:, None] + b.sum(1)[None, :] - torch.cdist(a, b, p=1)) / 2
    ops_ms = 2.0 * m * n * k / PEAK_FP32_OPS * 1e3
    bytes_ms = 4.0 * (m * k + n * k + m * n) / PEAK_BYTES * 1e3
    # one FMNMX and one FADD issued per triple; 4 schedulers x 32 lanes per SM
    max_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ms = 2.0 * m * n * k / (sms * 128 * max_mhz * 1e6) * 1e3
    log("kernel_time", kernel="minplus", shape=[m, n, k], ms=kernel_ms, plain_ms=plain_ms,
        unaligned_rows_ms=dense_ms,
        library_ms=library_ms, library_max_abs_diff=float((via_cdist - out).abs().max()),
        ops_bound_ms=ops_ms, bytes_bound_ms=bytes_ms, issue_bound_ms=issue_ms, sms=sms,
        clocks_max_sm_mhz=max_mhz, clocks_sm_mhz_during=float(sm_mhz),
        power_draw_w_during=float(power_w), max_abs_err=err)
    del a, b, out, plain, via_cdist
    torch.cuda.empty_cache()
    by_shape = {what: kernel_time_at(shape, gen, max_mhz, sms)
                for what, shape in (("serve_padded", SERVE_SHAPE), ("staged_slab", STAGED_SLAB_SHAPE),
                                    ("sharded_tail_slab", SHARDED_TAIL_SLAB_SHAPE))}
    return {
        "name": "minplus", "route": "cuda", "source": "grl_tpu_torch/csrc/minplus.cu",
        "replaces": "grl_tpu/ops/minplus.py:38", "shape": [m, n, k],
        "max_abs_err": worst, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "issue_bound_ms": issue_ms, "library_ms": library_ms, "by_shape": by_shape,
    }


def kernel_time_at(shape, gen, max_mhz, sms):
    """The kernel at one more of the path's shapes, on V-like aligned rows:
    ms, plain ms, ``cdist(p=1)`` ms and the bounds, as at MARS."""
    m, n, k = shape
    a, b = row_normalized(m, k, gen, padded=True), row_normalized(n, k, gen, padded=True)
    ms = cuda_ms(lambda: ops.minplus(a, b), reps=20)
    err = float((ops.minplus(a, b) - ops.minplus_plain(a, b)).abs().max())
    plain_ms = cuda_ms(lambda: ops.minplus_plain(a, b), reps=1)
    library_ms = cuda_ms(lambda: torch.cdist(a, b, p=1), reps=1)
    ops_ms = 2.0 * m * n * k / PEAK_FP32_OPS * 1e3
    bytes_ms = 4.0 * (m * k + n * k + m * n) / PEAK_BYTES * 1e3
    issue_ms = 2.0 * m * n * k / (sms * 128 * max_mhz * 1e6) * 1e3
    row = {"shape": [m, n, k], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "ops_bound_ms": ops_ms, "bytes_bound_ms": bytes_ms, "issue_bound_ms": issue_ms,
           "max_abs_err": err}
    log("kernel_time", kernel="minplus", **row)
    check(err <= KERNEL_TOL, f"minplus at {shape} max abs err {err}")
    del a, b
    torch.cuda.empty_cache()
    return row


NEAREST_K = 21  # max(k1 + 1, k2) at re-ranking's defaults
NEAREST_SHAPES = (("serve", SERVE_N), ("mars", MARS_N))


def joined_distances(n, gen, ids=636, dim=6144):
    """Re-ranking's joined, normalized distances (its ``original``) over n
    identity-clustered unit 6144-d rows, the serve cell's kind of index:
    each row's nearest are its identity's, then the rest."""
    centres = unit_rows(ids, dim, "cuda", gen)
    pick = torch.randint(0, ids, (n,), device="cuda", generator=gen)
    f = centres[pick] + 0.8 * torch.randn(n, dim, device="cuda", generator=gen) / dim**0.5
    f = f / f.norm(dim=1, keepdim=True)
    d = (2.0 - 2.0 * (f @ f.T)).clamp_(min=0.0)  # squared distances of unit rows
    return (d / d.max(dim=0).values).T.contiguous()


def nearest_cases(gen):
    """(what, x, k) on random, clustered, tied and padded rows at the
    design's edges: k from 1 to 100, n from 13 to 32768, a row stride past n."""
    uniform = torch.rand(1024, 16384, device="cuda", generator=gen)
    lattice = torch.randint(0, 4, (1024, 16384), device="cuda", generator=gen).float()
    padded = torch.full((2048, SERVE_N), 2.0, device="cuda").fill_diagonal_(0.0)
    clustered = joined_distances(2048, gen)
    wide = torch.rand(600, SERVE_N + 5, device="cuda", generator=gen)
    for k in (1, 6, 21, 32, 41):
        yield f"uniform 1024x16384 k={k}", uniform, k
        yield f"lattice 0..3, 1024x16384 k={k}", lattice, k
        yield f"padded rows (0 diagonal, 2.0 elsewhere) 2048x{SERVE_N} k={k}", padded, k
        yield f"clustered 2048x2048 k={k}", clustered, k
    yield f"row-strided 600x{SERVE_N} (row stride {SERVE_N + 5}) k=21", wide[:, 5:], 21
    yield "uniform 300x13, k=21 clamped to 13", torch.rand(300, 13, device="cuda", generator=gen), 21
    yield "all tied 64x700 k=32", torch.zeros(64, 700, device="cuda"), 32
    yield "all tied 64x700 k=100 (four rounds)", torch.zeros(64, 700, device="cuda"), 100
    yield "uniform 256x32768 (the widest row) k=21", torch.rand(256, 32768, device="cuda", generator=gen), 21


def phase_nearest(gen):
    """The selection kernel against its plain version (the stable argsort's
    first k columns), index for index, on ``nearest_cases``; then timed at
    the serve route's and MARS's re-ranking shapes on clustered distances,
    beside its bound (one read of the matrix), the plain version and
    ``torch.topk`` on unique int64 keys (the float's bits << 32 | column),
    which computes the same lists and which the port never calls."""
    for what, x, k in nearest_cases(gen):
        got = ops.nearest_k(x, k)
        torch.cuda.synchronize()
        want = ops.nearest_plain(x, k)
        mismatched_rows = int((got != want).any(dim=1).sum())
        log("kernel_check", kernel="nearest", case=what, mismatched_rows=mismatched_rows)
        check(mismatched_rows == 0, f"nearest {what}: {mismatched_rows} rows differ from the stable argsort")
    torch.cuda.empty_cache()

    max_mhz = float(nvidia_smi("clocks.max.sm", units=False))
    by_shape = {}
    for name, n in NEAREST_SHAPES:
        x, k = joined_distances(n, gen), NEAREST_K
        before = ops.nearest_k.launches
        got = ops.nearest_k(x, k)
        torch.cuda.synchronize()
        check(ops.nearest_k.launches == before + 1, "nearest_k did not launch its kernel")
        ms, (sm_mhz, power_w) = cuda_ms(lambda: ops.nearest_k(x, k), reps=20,
                                        during=lambda: nvidia_smi("clocks.sm,power.draw", units=False).split(", "))
        plain_ms = cuda_ms(lambda: ops.nearest_plain(x, k), reps=3)
        equal = bool(torch.equal(got, ops.nearest_plain(x, k)))
        # the distances are non-negative, so their bits order as they do
        keys = (x.view(torch.int32).long() << 32) | torch.arange(n, device="cuda")
        library_ms = cuda_ms(lambda: torch.topk(keys, k, dim=1, largest=False), reps=3)
        library_equal = bool(torch.equal(got, torch.topk(keys, k, dim=1, largest=False).indices))
        del keys
        bound_ms = (4.0 * n * n + 8.0 * n * k) / PEAK_BYTES * 1e3
        row = {"shape": [n, n, k], "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "bytes", "equal_to_plain": equal, "library_equal": library_equal,
               "clocks_max_sm_mhz": max_mhz, "clocks_sm_mhz_during": float(sm_mhz),
               "power_draw_w_during": float(power_w)}
        log("kernel_time", kernel="nearest", case=name, **row)
        check(equal and library_equal, f"nearest at {name}: equal to plain {equal}, to topk {library_equal}")
        by_shape[name] = row
        del x, got
        torch.cuda.empty_cache()
    serve = by_shape["serve"]
    return {"name": "nearest", "route": "cuda", "source": "grl_tpu_torch/csrc/nearest.cu",
            "replaces": "no Pallas kernel: jax.lax.top_k at grl_tpu/engine/rerank.py:703, 727",
            "shape": serve["shape"], "ms": serve["ms"], "plain_ms": serve["plain_ms"],
            "library_ms": serve["library_ms"], "bound_ms": serve["bound_ms"], "bound_by": "bytes",
            "by_shape": by_shape}


@torch.no_grad()
def calibrate_bn(model, run):
    """Set every BN's running stats to the batch stats of one calibration
    run, so eval-mode activations stay O(1) at random weights."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average
    model.train()
    run()
    for m in bns:
        m.momentum = 0.1
    model.eval()


def phase_model(gen):
    """Full-width descriptor: card against CPU on one seeded clip."""
    cnn = models.create("resnet50_grl", device="cuda", seed=0)
    sia = models.create("siamese", device="cuda", seed=1, input_num=cnn.num_feat, output_num=512)
    # two clips to calibrate (BatchNorm1d needs a batch above 1 in train mode), one to check
    clips = torch.randint(0, 256, (2, 8, 256, 128, 3), dtype=torch.uint8, device="cuda", generator=gen)
    calibrate_bn(cnn, lambda: cnn(normalize(clips)))
    calibrate_bn(sia, lambda: sia.self_attention(cnn(normalize(clips))[1]))
    clip = clips[:1]
    with torch.no_grad():
        t0 = time.perf_counter()
        d_gpu = make_descriptor_fn(cnn, sia)(clip)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
        cnn_cpu = models.create("resnet50_grl", device="cpu")
        cnn_cpu.load_state_dict(cnn.state_dict())
        sia_cpu = models.create("siamese", device="cpu", input_num=cnn.num_feat, output_num=512)
        sia_cpu.load_state_dict(sia.state_dict())
        t0 = time.perf_counter()
        d_cpu = make_descriptor_fn(cnn_cpu.eval(), sia_cpu.eval())(clip.cpu())
        cpu_s = time.perf_counter() - t0
    check(tuple(d_gpu.shape) == (1, 3 * cnn.num_feat), f"descriptor shape {tuple(d_gpu.shape)}")
    check(bool(torch.isfinite(d_gpu).all()), "descriptor not finite")
    err = float((d_gpu.cpu() - d_cpu).abs().max())
    c = cnn.num_feat
    norms = [float(d_gpu[0, i * c : (i + 1) * c].norm()) for i in range(3)]
    log("model_check", descriptor_dim=int(d_gpu.shape[1]), max_abs_diff_card_vs_cpu=err,
        segment_norms=norms, card_seconds=gpu_s, cpu_seconds=cpu_s)
    check(err <= MODEL_TOL, f"descriptor card vs CPU max abs diff {err}")
    return cnn, sia


def all_precision_flags(on):
    """Every flag of the precision policy (TF32 in cuDNN and cuBLAS,
    cuBLAS's bf16 reductions) on or off; the policy has them off."""
    set_precision_flags(dict.fromkeys(precision_flags(), on))


def check_fp32_policy(what, flags):
    check(not any(flags.values()), f"{what} ran outside the precision policy: {flags}")


@contextlib.contextmanager
def one_program_max(n):
    """Re-ranking's cut (``rerank.ONE_PROGRAM_MAX``) at ``n`` inside, as it
    was after."""
    saved, rerank_mod.ONE_PROGRAM_MAX = rerank_mod.ONE_PROGRAM_MAX, n
    try:
        yield
    finally:
        rerank_mod.ONE_PROGRAM_MAX = saved


@contextlib.contextmanager
def tf32(on):
    """TF32 on or off inside; the script's policy restored after."""
    all_precision_flags(on)
    try:
        yield
    finally:
        set_precision()


def descriptor_ms(cnn, sia, batch, reps=3):
    """Warm CUDA-event ms of one descriptor call on ``batch``, and the peak
    memory of the calls (GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = cuda_ms(lambda: make_descriptor_fn(cnn, sia)(batch), reps=reps)
    return {"ms": ms, "clips_per_s": batch.shape[0] * 1e3 / ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


@torch.no_grad()
def bn_bf16_check(gen):
    """cuDNN's BatchNorm on a bf16 input with fp32 parameters, in train mode:
    bf16 out, fp32 running statistics with the unbiased variance (as
    grl_tpu's ``nn/norm.py``), against the same on the CPU."""
    x = torch.randn(8, 64, 16, 8, device="cuda", generator=gen).to(torch.bfloat16)
    out = {}
    for device in ("cuda", "cpu"):
        bn = torch.nn.BatchNorm2d(64).to(device).train()
        y = bn(x.to(device))
        out[device] = (y, bn.running_var.clone())
    x64 = x.double()
    unbiased = 0.9 + 0.1 * x64.var(dim=(0, 2, 3), unbiased=True)
    (yg, vg), (yc, vc) = out["cuda"], out["cpu"]
    row = {"out_dtype": str(yg.dtype), "running_var_dtype": str(vg.dtype),
           "running_var_vs_unbiased": float((vg.double() - unbiased).abs().max()),
           "out_card_vs_cpu_max_abs": float((yg.float().cpu() - yc.float()).abs().max())}
    check(yg.dtype == torch.bfloat16 and vg.dtype == torch.float32, f"card BN on bf16: {row}")
    check(row["running_var_vs_unbiased"] <= 1e-5, f"card BN running variance: {row}")
    check(row["out_card_vs_cpu_max_abs"] <= 4 * 2.0**-8 * float(yc.float().abs().max()), f"card BN vs CPU: {row}")
    return row


def phase_model_bf16(gen):
    """The full-width bf16 descriptor: against the card's fp32 descriptor of
    the same weights and against bf16 on the CPU; warm rates of fp32 (TF32
    off and on), bf16, and bf16 with the modules in channels_last."""
    fp32 = grl_modules("cuda", seeds=(6, 7, 8))
    clips = torch.randint(0, 256, (8, 8, *FRAME, 3), dtype=torch.uint8, device="cuda", generator=gen)
    calibrate_grl(*fp32, clips)
    clips = clips[:4]
    cnn32, sia32 = fp32[0].eval(), fp32[1].eval()
    cnn, sia, _ = (m.eval() for m in recast(fp32, torch.bfloat16))
    check(cnn.backbone.base.conv1.compute_dtype == torch.bfloat16, "bf16 modules")
    def run(cnn, sia, clips):
        """(descriptor, TRL features before the BN-neck: per clip, per frame)"""
        with torch.inference_mode():
            x_uncorr, x_corr, _ = cnn.backbone(normalize(clips))
            f_uncorr, f_corr = cnn.temporal_learning_block((x_uncorr, x_corr))
            return make_descriptor_fn(cnn, sia)(clips), f_uncorr, f_corr.flatten(0, 1)

    def cos(a, b, centre=False):
        a, b = a.float().cpu(), b.float().cpu()
        if centre:
            a, b = a - a.mean(0), b - b.mean(0)
        return float(torch.nn.functional.cosine_similarity(a, b, dim=1).min())

    def distances(a, b, limit):
        (da, ua, ca), (db, ub, cb) = a, b
        c = da.shape[1] // 3
        return {"descriptor_min_cosine_per_segment": [cos(da[:, i * c:(i + 1) * c], db[:, i * c:(i + 1) * c])
                                                      for i in range(3)],
                "descriptor_max_abs": float((da.cpu() - db.cpu()).abs().max()),
                "pre_neck_min_cosine": {"uncentred": {"uncorr": cos(ua, ub), "corr": cos(ca, cb)},
                                        "centred": {"uncorr": cos(ua, ub, True), "corr": cos(ca, cb, True)}},
                "limit": {"pre_neck_min_cosine": limit}}

    out16, out32 = run(cnn, sia, clips), run(cnn32, sia32, clips)
    vs_fp32 = distances(out16, out32, BF16_COSINE_MIN["vs_fp32"])
    # the same bf16 modules on the CPU, at 2 clips
    cpu_cnn, cpu_sia, _ = recast((cnn, sia, fp32[2]), torch.bfloat16, device="cpu")
    t0 = time.perf_counter()
    out_cpu = run(cpu_cnn.eval(), cpu_sia.eval(), clips[:2].cpu())
    cpu_s = time.perf_counter() - t0
    del cpu_cnn, cpu_sia
    card_vs_cpu = distances([o[: len(p)] for o, p in zip(out16, out_cpu)], out_cpu, BF16_COSINE_MIN["card_vs_cpu"])
    # how much the BN-neck scales an error of its input up: |mean| / std of
    # its calibrated statistics (median over channels)
    neck_gain = {k: float((bn.running_mean.abs() / (bn.running_var + bn.eps).sqrt()).median())
                 for k, bn in (("corr", cnn32.corr_bn), ("uncorr", cnn32.uncorr_bn))}
    bn = bn_bf16_check(gen)
    d16 = out16[0]
    log("model_bf16", dtype=str(d16.dtype), vs_fp32_on_card=vs_fp32, card_vs_cpu_bf16=card_vs_cpu,
        cpu_seconds=cpu_s, neck_gain=neck_gain, batchnorm=bn)
    check(d16.dtype == torch.float32 and bool(torch.isfinite(d16).all()), "bf16 descriptor dtype or values")
    for what, r in (("bf16 vs fp32 on the card", vs_fp32), ("bf16 card vs CPU", card_vs_cpu)):
        for kind, limit in r["limit"]["pre_neck_min_cosine"].items():
            check(min(r["pre_neck_min_cosine"][kind].values()) >= limit, f"features {what}, {kind}: {r}")

    # warm rates; each configuration in turn, fp32 first and last
    rates = {}
    for mb in (32, 96):
        batch = torch.randint(0, 256, (mb, 8, *FRAME, 3), dtype=torch.uint8, device="cuda", generator=gen)
        rates[f"fp32_mb{mb}"] = descriptor_ms(cnn32, sia32, batch)
        with tf32(True):
            rates[f"fp32_tf32_mb{mb}"] = descriptor_ms(cnn32, sia32, batch)
        rates[f"bf16_mb{mb}"] = descriptor_ms(cnn, sia, batch)
        # channels_last: the modules' 4-d weights in NHWC (the frames that
        # enter the trunk are an NHWC view of the clips already)
        cnn.to(memory_format=torch.channels_last)
        rates[f"bf16_channels_last_mb{mb}"] = descriptor_ms(cnn, sia, batch)
        cnn.to(memory_format=torch.contiguous_format)
        rates[f"fp32_again_mb{mb}"] = descriptor_ms(cnn32, sia32, batch)
        del batch
    log("descriptor_rates", frames=8, frame=list(FRAME), **rates)
    del cnn, sia, cnn32, sia32, fp32
    torch.cuda.empty_cache()
    return rates


def phase_slice(cnn, sia):
    """The main path, through the entry points a user calls."""
    t0 = time.perf_counter()
    ds = SyntheticVideoReID(num_train_ids=0, num_test_ids=24, tracklets_per_id=2, num_cams=2,
                            frames_range=(8, 40), height=256, width=128, seed=0)
    n_clips = sum(len(dense_indices(t[0].shape[0], 8)) for t in ds.query + ds.gallery)
    loader = lambda items: ClipLoader(ClipDataset(items, 8, "dense", 256, 128), batch_size=1, workers=4)
    log("slice_setup", query=len(ds.query), gallery=len(ds.gallery), clips=n_clips,
        catalog_seconds=time.perf_counter() - t0)
    evaluator = Evaluator(cnn, sia, micro_batch=32, rerank=True, device="cuda")

    for fn in ops.KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluator.evaluate(loader(ds.query), loader(ds.gallery))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}

    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    check(tuple(res.distmat.shape) == (len(ds.query), len(ds.query) + len(ds.gallery)),
          f"distmat shape {tuple(res.distmat.shape)}")
    check(bool(torch.isfinite(res.distmat).all()), "re-ranked distmat not finite")
    plain = re_ranking(cosine_distance(res.qf, res.gf), _euclidean(res.qf, res.qf),
                       _euclidean(res.gf, res.gf), min_sum_fn=ops.minplus_plain)
    err = float((plain - res.distmat).abs().max())
    q_pids = np.array(ds.queryinfo.pid)
    q_cams = np.array(ds.queryinfo.camid)
    cmc_cos, map_cos = metrics.evaluate_device(
        cosine_distance(res.qf, res.gf), q_pids, np.append(q_pids, ds.galleryinfo.pid),
        q_cams, np.append(q_cams, ds.galleryinfo.camid))
    log("slice", seconds=seconds, clips=n_clips, clips_per_s=n_clips / seconds,
        rank1=float(res.cmc[0]), rank5=float(res.cmc[4]), mAP=res.mAP, launches=launches,
        rank1_without_rerank=float(cmc_cos[0]), mAP_without_rerank=map_cos,
        rerank_vs_plain_max_abs_diff=err, tf32=False)
    check(err <= KERNEL_TOL, f"re-ranking with the kernel vs plain min-sum: {err}")
    check(np.isfinite(res.cmc).all() and 0.0 <= res.mAP <= 1.0, "protocol out of range")
    return launches


def phase_mars(gen):
    """Re-ranking + device protocol at MARS scale on random 6144-d features."""
    def unit(rows):
        x = torch.randn(rows, 6144, device="cuda", generator=gen)
        return x / x.norm(dim=1, keepdim=True)

    qf = unit(MARS_Q)
    gf = torch.cat([qf, unit(MARS_EXTRA_G)])  # gallery = query ∪ gallery
    rng = np.random.RandomState(0)
    q_pids = rng.randint(0, MARS_Q, MARS_Q)
    g_pids = np.concatenate([q_pids, rng.randint(0, MARS_Q, MARS_EXTRA_G)])
    q_cams = rng.randint(0, 6, MARS_Q)
    g_cams = np.concatenate([q_cams, rng.randint(0, 6, MARS_EXTRA_G)])

    def run():
        times = {}
        t0 = time.perf_counter()
        dists = cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf)
        torch.cuda.synchronize()
        times["distances_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        final = re_ranking(*dists)
        torch.cuda.synchronize()
        times["rerank_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cmc, mAP = metrics.evaluate_device(final, q_pids, g_pids, q_cams, g_cams)
        times["protocol_s"] = time.perf_counter() - t0
        return final, cmc, mAP, times

    run()  # warm
    torch.cuda.reset_peak_memory_stats()
    final, cmc, mAP, times = run()
    check(tuple(final.shape) == (MARS_Q, MARS_Q + MARS_EXTRA_G), f"shape {tuple(final.shape)}")
    check(bool(torch.isfinite(final).all()) and np.isfinite(cmc).all(), "MARS rerank not finite")
    log("mars_rerank", queries=MARS_Q, gallery=MARS_Q + MARS_EXTRA_G, **times,
        total_s=sum(times.values()), peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        rank1=float(cmc[0]), mAP=mAP)

    # where the tail's device time goes, from one more (profiled) run
    log("mars_profile", **device_profile(run))


def grl_modules(device, seeds=(0, 1, 2), compute_dtype=None):
    cd = compute_dtype
    cnn = models.create("resnet50_grl", device=device, seed=seeds[0], compute_dtype=cd)
    sia = models.create("siamese", device=device, seed=seeds[1], input_num=cnn.num_feat, output_num=512,
                        compute_dtype=cd)
    unc = models.create("siamese_video", device=device, seed=seeds[2], input_num=cnn.num_feat, compute_dtype=cd)
    return cnn, sia, unc


def recast(modules, compute_dtype, device=None):
    """Copies of ``modules`` with the same weights and statistics, built
    with ``compute_dtype`` (on ``device``, default the modules')."""
    cnn, sia, unc = modules
    device = device or next(cnn.parameters()).device
    out = grl_modules(device, compute_dtype=compute_dtype)
    for new, old in zip(out, modules):
        new.load_state_dict(old.state_dict())
    return out


def calibrate_grl(cnn, sia, unc, clips_u8):
    x = lambda: cnn(normalize(clips_u8))
    calibrate_bn(cnn, x)
    calibrate_bn(sia, lambda: sia(x()[1]))
    calibrate_bn(unc, lambda: unc(x()[0]))


def bn_layers(models_dict):
    return [(n, m) for n, m in models_dict.named_modules()
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


def one_train_step(modules, device, dtype, clips, targets, luts):
    """One training step of copies of ``modules`` on ``device`` in ``dtype``;
    returns (metrics, per-leaf updates, luts after), on the host in fp64."""
    mods = [copy.deepcopy(m).to(device, dtype) for m in modules]
    state = init_train_state(*mods, luts["corr"].shape[0], num_feat=luts["corr"].shape[1], device=device)
    state.luts = {k: v.to(device, dtype) for k, v in luts.items()}
    before = {k: v.detach().double().cpu().clone() for k, v in state.models.state_dict().items()}
    t0 = time.perf_counter()
    state, m = make_train_step(device=device)(state, clips.to(device, dtype), targets, TRAIN_LR)
    m = {k: float(v) for k, v in m.items()}  # waits for the step
    seconds = time.perf_counter() - t0
    updates = {k: v.detach().double().cpu() - before[k] for k, v in state.models.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    return m, updates, {k: v.double().cpu() for k, v in state.luts.items()}, seconds


def compare_steps(a, b):
    """Step ``a`` against step ``b``: loss terms (relative), each parameter
    update (max abs difference as a share of b's largest element, plus
    TRAIN_LR x 1e-9: the biases in front of a BN have a zero gradient in
    exact arithmetic), all parameter updates together (L2, as a share of
    b's), BN running-statistic updates and luts (max abs)."""
    (am, au, al, _), (bm, bu, bl, _) = a, b
    stats = [k for k in bu if k.endswith(("running_mean", "running_var"))]
    params = [k for k in bu if k not in stats]
    leaf = {k: float((au[k] - bu[k]).abs().max() / (bu[k].abs().max() + TRAIN_LR * 1e-9)) for k in params}
    flat = lambda u: torch.cat([u[k].flatten() for k in params])
    return {
        "loss": max(abs(am[k] - bm[k]) / abs(bm[k]) for k in bm if k.startswith("loss")),
        "leaf": max(leaf.values()),
        "leaf_worst": sorted(leaf.items(), key=lambda kv: -kv[1])[:4],
        "all_l2": float((flat(au) - flat(bu)).norm() / flat(bu).norm()),
        "bn": max(float((au[k] - bu[k]).abs().max()) for k in stats),
        "lut": max(float((al[k] - bl[k]).abs().max()) for k in bl),
    }


def phase_train_check(gen):
    """One full-width training step on the card against the same step on
    the CPU, from the same weights, luts and batch (augmentation off), in
    fp64 and in fp32 (the training precision)."""
    num_classes = 8
    clips_u8 = torch.randint(0, 256, (4, 8, *FRAME, 3), dtype=torch.uint8, device="cuda", generator=gen)
    clips = normalize(clips_u8).cpu()
    targets = np.array([0, 0, 5, 5])
    modules = grl_modules("cuda")
    feat = modules[0].num_feat
    luts = {k: torch.randn(num_classes, feat, device="cuda", generator=gen) for k in ("corr", "uncorr")}
    luts = {k: (v / v.norm(dim=1, keepdim=True)).cpu() for k, v in luts.items()}
    calibrate_grl(*modules, clips_u8)
    runs = {(device, dtype): one_train_step(modules, device, dtype, clips, targets, luts)
            for dtype in (torch.float64, torch.float32) for device in ("cuda", "cpu")}
    exact = compare_steps(runs["cuda", torch.float64], runs["cpu", torch.float64])
    fp32 = compare_steps(runs["cuda", torch.float32], runs["cpu", torch.float32])
    card_vs_fp64 = compare_steps(runs["cuda", torch.float32], runs["cpu", torch.float64])
    cpu_vs_fp64 = compare_steps(runs["cpu", torch.float32], runs["cpu", torch.float64])
    card_m = runs["cuda", torch.float32][0]
    log("train_check", clips=4, frames=8, losses_card_fp32=card_m,
        seconds={f"{d} {str(t)[6:]}": r[3] for (d, t), r in runs.items()},
        card_vs_cpu_fp64=exact, card_vs_cpu_fp32=fp32, card_fp32_vs_fp64=card_vs_fp64,
        cpu_fp32_vs_fp64=cpu_vs_fp64, tol={"fp64": TRAIN_TOL_FP64, "fp32": TRAIN_TOL_FP32})
    check(all(np.isfinite(v) for v in card_m.values()), f"card step metrics not finite: {card_m}")
    for what, got, tol in (("fp64", exact, TRAIN_TOL_FP64), ("fp32", fp32, TRAIN_TOL_FP32)):
        for k, limit in tol.items():
            check(got[k] <= limit, f"training step card vs CPU, {what}, {k}: {got[k]} > {limit}")


def phase_train(gen, bf16=False):
    """``Trainer.train`` at the reference batch through the user's entry
    points; every kernel's launch count is zeroed just before. ``bf16``
    trains the modules ``cli.train --bf16`` builds (phases ``train_bf16``,
    ``train_bf16_profile``)."""
    name = "train_bf16" if bf16 else "train"
    t0 = time.perf_counter()
    ds = SyntheticVideoReID(num_train_ids=32, num_test_ids=12, tracklets_per_id=2, num_cams=2,
                            frames_range=(8, 24), height=FRAME[0], width=FRAME[1], seed=0)
    batch, steps = 16, 10
    loader = ClipLoader(ClipDataset(ds.train, 8, "rrs_train", *FRAME, seed=0), batch_size=batch,
                        sampler=RandomPairSampler(ds.train, seed=0), drop_last=True, workers=4,
                        max_batches=steps)
    if bf16:
        cnn, sia, unc = (m.to("cuda") for m in cli_train.build_models(
            cli_train.build_parser().parse_args(["--bf16", "--seed", "3"])))
        check(cnn.backbone.base.conv1.compute_dtype == torch.bfloat16
              and unc.classifierlinear.compute_dtype == torch.bfloat16, "cli.train --bf16 builds bf16 modules")
    else:
        cnn, sia, unc = grl_modules("cuda", seeds=(3, 4, 5))
    calibrate_grl(cnn, sia, unc, torch.randint(0, 256, (4, 8, *FRAME, 3), dtype=torch.uint8,
                                               device="cuda", generator=gen))
    state = init_train_state(cnn, sia, unc, ds.num_train_pids, num_feat=cnn.num_feat, device="cuda")
    params0 = {n: p.detach().clone() for n, p in state.models.named_parameters()}
    stats0 = {n: m.running_mean.clone() for n, m in bn_layers(state.models)}
    log(f"{name}_setup", train_tracklets=len(ds.train), ids=ds.num_train_pids, batch=batch,
        frames=8, steps=len(loader), catalog_seconds=time.perf_counter() - t0, lr=TRAIN_LR)

    step = make_train_step(device="cuda")
    records, seen = [], set()
    last_batch = None

    def timed_step(state, clips, targets, lr):
        nonlocal last_batch
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, clips, targets, lr)
        end.record()
        records.append((start, end, m))
        seen.update(int(t) for t in targets)
        last_batch = (clips, targets)
        return state, m

    for fn in ops.KERNELS.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, stats = Trainer(timed_step, print_freq=5, seed=0, device="cuda").train(0, state, loader, TRAIN_LR)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    n = len(records)
    warm_ms = records[1][0].elapsed_time(records[-1][1]) / (n - 1)
    step_ms = [s.elapsed_time(e) for s, e, _ in records]
    trajectory = [{k: float(v) for k, v in m.items()} for _, _, m in records]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    unchanged = [name for name, p in state.models.named_parameters()
                 if not name.startswith(UNREACHED) and torch.equal(p, params0[name])]
    still = [name for name, m in bn_layers(state.models)
             if not name.startswith("siamese.featV_bn") and torch.equal(m.running_mean, stats0[name])]
    lut_norms = {k: v.norm(dim=1).cpu() for k, v in state.luts.items()}
    ids = sorted(seen)
    # the step's convolution and matrix-product operations (forward and
    # backward, counted by torch), on a copy so the trained state stays
    clips, targets = last_batch
    with FlopCounterMode(display=False) as counter:
        total, _ = grl_loss_fn(copy.deepcopy(state.models).train(), state.luts, clips,
                               torch.as_tensor(targets, dtype=torch.int64, device=clips.device))
        total.backward()
    step_flop = counter.get_total_flops()
    bound_ms = step_flop / (PEAK_BF16_OPS if bf16 else PEAK_FP32_OPS) * 1e3
    # where a step's device time goes: two more steps of a copy, profiled
    probe = copy.deepcopy(state)
    profile = device_profile(lambda: [step(probe, clips, targets, TRAIN_LR) for _ in range(2)], top=15)
    del probe
    dtypes = {str(p.dtype) for p in state.models.parameters()} | {str(v.dtype) for v in state.luts.values()}
    log(name, steps=n, batch=batch, frames=8, seconds=seconds, loss=[t["loss"] for t in trajectory],
        trajectory=trajectory, warm_step_ms=warm_ms, warm_clips_per_s=batch * 1e3 / warm_ms,
        step_tflop=step_flop / 1e12, step_bound_ms=bound_ms, achieved_tflops=step_flop / warm_ms / 1e9,
        step_event_ms=step_ms, trainer=stats, peak_gib=peak_gib,
        precision_flags=precision_flags(), state_dtypes=sorted(dtypes), ids_seen=len(ids))
    log(f"{name}_profile", steps=2, **profile)
    check(n >= 8, f"only {n} training steps")
    check(dtypes == {"torch.float32"}, f"parameters and luts stay fp32: {dtypes}")
    check(all(np.isfinite(v) for t in trajectory for v in t.values()), "training metrics not finite")
    check(all(np.isfinite(v) for v in stats.values()), f"trainer stats not finite: {stats}")
    check(not unchanged, f"parameters the loss reaches did not change: {unchanged[:5]}")
    check(not still, f"BN running statistics did not move: {still[:5]}")
    for k, norms in lut_norms.items():
        err = float((norms[ids] - 1.0).abs().max())
        check(err <= 1e-5, f"lut {k}: rows of the ids seen are off unit norm by {err}")
        check(bool((norms[[i for i in range(len(norms)) if i not in seen]] == 0).all()),
              f"lut {k}: rows of ids not seen moved")
    return state, ds


def phase_precision_steps(state, ds, gen):
    """One full-width step in bf16 (``state``'s modules), fp32 and fp32
    with TF32 on, from the same weights, luts and batch (augmentation off),
    against an fp64 step on the card; then each precision's step ms at
    batch 16 (bf16 also with the modules in channels_last)."""
    batch = 16
    cnn = state.models["cnn"]
    clips = normalize(torch.randint(0, 256, (batch, 8, *FRAME, 3), dtype=torch.uint8, device="cuda",
                                    generator=gen))
    targets = np.repeat(np.arange(batch // 2), 2)
    step = make_train_step(device="cuda")

    # one step of each precision from the same weights, luts and batch
    # (augmentation off), held against an fp64 step on the card
    num_classes = 8
    bf16_modules = (cnn, state.models["siamese"], state.models["siamese_uncorr"])
    fp32_modules = recast(bf16_modules, None)
    small = clips[:4].cpu()
    ids = np.array([0, 0, 5, 5])
    luts = {k: torch.randn(num_classes, cnn.num_feat, device="cuda", generator=gen) for k in ("corr", "uncorr")}
    luts = {k: (v / v.norm(dim=1, keepdim=True)).cpu() for k, v in luts.items()}
    ref = one_train_step(fp32_modules, "cuda", torch.float64, small, ids, luts)
    runs = {"bf16": one_train_step(bf16_modules, "cuda", torch.float32, small, ids, luts),
            "fp32": one_train_step(fp32_modules, "cuda", torch.float32, small, ids, luts)}
    with tf32(True):
        runs["tf32"] = one_train_step(fp32_modules, "cuda", torch.float32, small, ids, luts)
    vs_fp64 = {k: compare_steps(r, ref) for k, r in runs.items()}

    # step ms at batch 16 per precision, in turns
    def ms_of(modules, channels_last=False):
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        st = init_train_state(*[copy.deepcopy(m).to(memory_format=fmt) for m in modules], ds.num_train_pids,
                              num_feat=cnn.num_feat, device="cuda")
        step(st, clips, targets, TRAIN_LR)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            step(st, clips, targets, TRAIN_LR)
        end.record()
        torch.cuda.synchronize()
        return {"ms": start.elapsed_time(end) / 5, "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    step_ms = {"fp32": ms_of(fp32_modules)}
    with tf32(True):
        step_ms["fp32_tf32"] = ms_of(fp32_modules)
    step_ms["bf16"] = ms_of(bf16_modules)
    step_ms["bf16_channels_last"] = ms_of(bf16_modules, channels_last=True)
    step_ms["fp32_again"] = ms_of(fp32_modules)
    log("precision_steps", clips=4, frames=8, batch_for_ms=batch, vs_fp64=vs_fp64, step_ms=step_ms,
        losses={k: r[0] for k, r in runs.items()})
    for k, r in runs.items():
        check(all(np.isfinite(v) for v in r[0].values()), f"{k} step metrics not finite")
    return step_ms, vs_fp64


def phase_train_eval(state, ds):
    """The closing evaluation with re-ranking on the trained modules."""
    loader = lambda items: ClipLoader(ClipDataset(items, 8, "dense", *FRAME), batch_size=1, workers=4)
    evaluator = Evaluator(state.models["cnn"], state.models["siamese"], micro_batch=32, rerank=True,
                          device="cuda")
    t0 = time.perf_counter()
    res = evaluator.evaluate(loader(ds.query), loader(ds.gallery))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in ops.KERNELS.items()}
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the training path")
    check(bool(torch.isfinite(res.distmat).all()), "re-ranked distmat not finite")
    plain = re_ranking(cosine_distance(res.qf, res.gf), _euclidean(res.qf, res.qf),
                       _euclidean(res.gf, res.gf), min_sum_fn=ops.minplus_plain)
    err = float((plain - res.distmat).abs().max())
    log("train_eval", seconds=seconds, query=len(ds.query), gallery=len(ds.gallery), launches=launches,
        rank1=float(res.cmc[0]), mAP=res.mAP, rerank_vs_plain_max_abs_diff=err)
    check(err <= KERNEL_TOL, f"re-ranking after training, kernel vs plain min-sum: {err}")
    check(np.isfinite(res.cmc).all() and 0.0 <= res.mAP <= 1.0, "protocol out of range")
    return launches


def dp_modules(device, tiny=False):
    """The GRL modules of ``train_check`` (seeds 0-2), or ``tiny`` ones for a
    CPU rehearsal."""
    if not tiny:
        return grl_modules(device)
    cnn = models.create("resnet50_grl", device=device, seed=0, trunk=models.ResNetTrunk(layers=(1, 1, 1, 1), width=4))
    sia = models.create("siamese", device=device, seed=1, input_num=cnn.num_feat, output_num=512)
    unc = models.create("siamese_video", device=device, seed=2, input_num=cnn.num_feat)
    return cnn, sia, unc


def group_train_step(modules, mesh, clips, targets, luts):
    """``one_train_step`` through the group step on ``mesh`` (this rank's
    slice of the batch), from copies of ``modules``."""
    mods = [copy.deepcopy(m) for m in modules]
    state = init_train_state(*mods, luts["corr"].shape[0], num_feat=luts["corr"].shape[1], device=mesh.device)
    state.luts = {k: v.to(mesh.device) for k, v in luts.items()}
    parallel.sharded_train_state(state, mesh)
    before = {k: v.detach().double().cpu().clone() for k, v in state.models.state_dict().items()}
    t0 = time.perf_counter()
    state, m = make_train_step(mesh=mesh)(state, parallel.shard_batch(clips, mesh).to(mesh.device),
                                          parallel.shard_batch(targets, mesh), TRAIN_LR)
    m = {k: float(v) for k, v in m.items()}
    seconds = time.perf_counter() - t0
    updates = {k: v.detach().double().cpu() - before[k] for k, v in state.models.state_dict().items()
               if not k.endswith("num_batches_tracked")}
    return m, updates, {k: v.double().cpu() for k, v in state.luts.items()}, seconds


DP_BN_SHAPE = (128, 64, 128, 64)  # the trunk's first BatchNorm at batch 16 x 8 frames of 256x128
DP_BN_TOL = {"float32": 1e-4, "bfloat16": 2.0**-6}  # of the reference's largest magnitude


def dp_bn_check(device, gen, shape=DP_BN_SHAPE):
    """``GlobalBatchNorm`` in train mode on one rank (the fused ops on a
    card, the two-pass Function on the CPU) against torch's BatchNorm2d on
    the same input: at one rank the global batch is the local one. fp32 and
    bf16 inputs (fp32 parameters): output, the three gradients and the
    running statistics, each relative to the reference's largest magnitude;
    on a card the ms of a forward and backward of each, and of the two-pass
    Function on the card."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(shape, device=device, generator=gen).mul_(2).add_(0.5).to(dtype)
        dy = torch.randn(shape, device=device, generator=gen).to(dtype)
        ref = torch.nn.BatchNorm2d(shape[1]).to(device).train()
        with torch.no_grad():
            ref.weight.copy_(torch.rand(shape[1], device=device, generator=gen) + 0.5)
            ref.bias.copy_(torch.randn(shape[1], device=device, generator=gen))
        glob = convert_global_batchnorm(torch.nn.Sequential(copy.deepcopy(ref)))[0]

        def run(bn):
            xr = x.detach().requires_grad_(True)
            y = bn(xr)
            y.backward(dy)
            return [y, xr.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var]

        got, want = run(glob), run(ref)
        names = ("out", "grad_input", "grad_weight", "grad_bias", "running_mean", "running_var")
        err = {k: float((a.detach().float() - b.float()).abs().max() / b.float().abs().max())
               for k, a, b in zip(names, got, want)}
        row = {"shape": list(shape), "rel_err": err, "tol": DP_BN_TOL[str(dtype)[6:]], "out_dtype": str(got[0].dtype),
               "global_ms": None, "torch_ms": None, "two_pass_ms": None}
        if torch.device(device).type == "cuda":
            two_pass = lambda xr: _GlobalBatchNormFn.apply(xr, ref.weight, ref.bias, ref.eps)[0]
            for k, fn in (("global_ms", glob), ("torch_ms", ref), ("two_pass_ms", two_pass)):
                row[k] = cuda_ms(lambda: fn(x.detach().requires_grad_(True)).backward(dy), 5)
        rows[str(dtype)[6:]] = row
        del x, dy, got, want
    return rows


class StepClock:
    """Each step's ms: CUDA events on a card, the host clock on the CPU."""

    def __init__(self, step, device):
        self.step, self.cuda, self.ms = step, torch.device(device).type == "cuda", []

    def __call__(self, state, clips, targets, lr):
        if self.cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = self.step(state, clips, targets, lr)
            end.record()
            self.ms.append((start, end))
        else:
            t0 = time.perf_counter()
            state, m = self.step(state, clips, targets, lr)
            self.ms.append(time.perf_counter() - t0)
        return state, m

    def read(self):
        sync("cuda" if self.cuda else "cpu")
        return [s.elapsed_time(e) for s, e in self.ms] if self.cuda else [t * 1e3 for t in self.ms]


def dp_rank_job(opts):
    """The ``data_parallel`` phase's work on rank 0 of a one-rank group."""
    mesh = parallel.data_mesh()
    device, frame, tiny = mesh.device, tuple(opts["frame"]), opts["tiny"]
    set_precision()
    gen = torch.Generator(device=device).manual_seed(8)
    since = time.perf_counter()
    marks = {}

    def mark(what):  # wall seconds of each part of the child's work
        nonlocal since
        sync(device)
        marks[what] = time.perf_counter() - since
        since = time.perf_counter()

    out = {"mesh": repr(mesh), "backend": torch.distributed.get_backend(), "part_seconds": marks}

    # one step at batch 16 from one state: the group step against the plain step
    batch, num_classes = 16, 8
    modules = dp_modules(device, tiny)
    clips_u8 = torch.randint(0, 256, (batch, 8, *frame, 3), dtype=torch.uint8, device=device, generator=gen)
    calibrate_grl(*modules, clips_u8[:4])
    clips = normalize(clips_u8).cpu()
    targets = np.repeat(np.arange(batch // 2) % num_classes, 2)
    feat = modules[0].num_feat
    luts = {k: torch.randn(num_classes, feat, device=device, generator=gen) for k in ("corr", "uncorr")}
    luts = {k: (v / v.norm(dim=1, keepdim=True)).cpu() for k, v in luts.items()}
    mark("modules")
    plain = one_train_step(modules, device, torch.float32, clips, targets, luts)
    group = group_train_step(modules, mesh, clips, targets, luts)
    mark("step")
    out["step"] = {"vs_plain": compare_steps(group, plain), "tol": TRAIN_TOL_FP32,
                   "losses": {"group": group[0], "plain": plain[0]}, "seconds": {"group": group[3], "plain": plain[3]}}
    del plain, group
    empty_cache(device)
    out["bn"] = dp_bn_check(device, gen, (8, 16, 16, 8) if tiny else DP_BN_SHAPE)
    empty_cache(device)
    mark("bn")

    # Trainer.train, 3 steps at batch 16 under the group, and the plain trainer beside it
    ds = SyntheticVideoReID(num_train_ids=16, num_test_ids=2, tracklets_per_id=2, num_cams=2, frames_range=(8, 24),
                            height=frame[0], width=frame[1], seed=0)
    steps = 3

    def loader(batch_slice=None):
        return ClipLoader(ClipDataset(ds.train, 8, "rrs_train", *frame, seed=0), batch_size=batch,
                          sampler=RandomPairSampler(ds.train, seed=0), drop_last=True, workers=4,
                          max_batches=steps, batch_slice=batch_slice)

    runs = {}
    for name in ("group", "plain"):
        state = init_train_state(*copy.deepcopy(modules), ds.num_train_pids, num_feat=feat, device=device)
        on = mesh if name == "group" else None
        if on is not None:
            parallel.sharded_train_state(state, on)
        step = make_train_step(device=device, mesh=on)
        clock = StepClock(step, device)
        data = loader(slice(0, batch)) if on is not None else loader()
        state, stats = Trainer(clock, print_freq=100, seed=0, device=device, mesh=on).train(0, state, data, TRAIN_LR)
        runs[name] = {"step_ms": clock.read(), "loss": stats["loss"],
                      "bn_global": sum(isinstance(m, GlobalBatchNorm) for m in state.models.modules())}
        if name == "group" and not tiny:
            # where the group step's device time goes: two more steps, profiled
            x = normalize(clips_u8)
            runs["group_profile"] = device_profile(lambda: [step(state, x, targets, TRAIN_LR) for _ in range(2)],
                                                   top=12)
        del state
        empty_cache(device)
    runs["group_minus_plain_warm_ms"] = (statistics.mean(runs["group"]["step_ms"][1:])
                                         - statistics.mean(runs["plain"]["step_ms"][1:]))
    out["train"] = runs
    mark("train")

    # the striped, re-ranked evaluation of the slice's catalog, against one card
    ev = SyntheticVideoReID(num_train_ids=0, num_test_ids=24, tracklets_per_id=2, num_cams=2, frames_range=(8, 40),
                            height=frame[0], width=frame[1], seed=0)
    cnn, sia = modules[:2]
    dense = lambda items: ClipLoader(ClipDataset(items, 8, "dense", *frame), batch_size=1, workers=4)
    mark("eval_catalog")
    one = Evaluator(cnn, sia, micro_batch=32, rerank=True, device=device).evaluate(dense(ev.query), dense(ev.gallery))
    meta = {"query": parallel.eval_catalog_meta(ev.query), "gallery": parallel.eval_catalog_meta(ev.gallery)}
    stripes = [parallel.stripe_catalog(items)[0] for items in (ev.query, ev.gallery)]
    zero_launches()
    sync(device)
    t0 = time.perf_counter()
    res = Evaluator(cnn, sia, micro_batch=32, rerank=True, device=device, mesh=mesh).evaluate(
        dense(stripes[0]), dense(stripes[1]), multihost=meta)
    sync(device)
    out["evaluate"] = {"seconds": time.perf_counter() - t0, "launches": read_launches(),
                       "rank1": float(res.cmc[0]), "mAP": res.mAP, "one_card_rank1": float(one.cmc[0]),
                       "one_card_mAP": one.mAP, "distmat_max_abs_diff": float((res.distmat - one.distmat).abs().max()),
                       "finite": bool(torch.isfinite(res.distmat).all()), "query": len(ev.query),
                       "gallery": len(ev.gallery)}
    mark("evaluate")
    return out


def empty_cache(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def phase_data_parallel(device="cuda", tiny=False, frame=FRAME, cli_extra=()):
    """The ``data_parallel`` phase (the module docstring, 21); returns the
    min-plus kernel's launches in the group's evaluation."""
    t0 = time.perf_counter()
    out = parallel.launch(dp_rank_job, {"frame": list(frame), "tiny": tiny}, 1, device, timeout=600)[0]
    child_s = time.perf_counter() - t0
    step, train, ev = out["step"], out["train"], out["evaluate"]
    log("dp_step", mesh=out["mesh"], backend=out["backend"], batch=16, frames=8, frame=list(frame),
        part_seconds=out["part_seconds"], **step)
    log("dp_train", steps=3, batch=16, **{k: v for k, v in train.items() if k != "group_profile"})
    if "group_profile" in train:
        log("dp_train_profile", steps=2, **train["group_profile"])
    log("dp_evaluate", **ev, tol=KERNEL_TOL)
    for dtype, row in out["bn"].items():
        log("dp_bn", dtype=dtype, **row)
        for k, err in row["rel_err"].items():
            check(err <= row["tol"], f"GlobalBatchNorm vs BatchNorm2d, {dtype} {k}: {err} > {row['tol']}")
    for k, limit in step["tol"].items():
        check(step["vs_plain"][k] <= limit, f"group step vs plain step, fp32, {k}: {step['vs_plain'][k]} > {limit}")
    check(all(np.isfinite(v) for v in step["losses"]["group"].values()), "group step metrics not finite")
    check(train["group"]["bn_global"] > 0 and train["plain"]["bn_global"] == 0,
          f"global BatchNorm where expected: {train['group']['bn_global']}, {train['plain']['bn_global']}")
    check(len(train["group"]["step_ms"]) == 3 and np.isfinite(train["group"]["loss"]), "group trainer did not train")
    check(ev["finite"], "striped re-ranked distmat not finite")
    check(ev["distmat_max_abs_diff"] <= KERNEL_TOL, f"striped vs one-card distmat: {ev['distmat_max_abs_diff']}")
    check(ev["rank1"] == ev["one_card_rank1"] and ev["mAP"] == ev["one_card_mAP"],
          f"striped rank-1/mAP {ev['rank1']}/{ev['mAP']} vs one card {ev['one_card_rank1']}/{ev['one_card_mAP']}")
    if torch.device(device).type == "cuda":
        check(ev["launches"]["minplus"] == 1, f"min-plus launches in the group's evaluation: {ev['launches']}")

    # cli.train --devices 2 where the script runs: capped at the visible cards
    logs = BUILD / "chip_dp_cli"
    shutil.rmtree(logs, ignore_errors=True)
    t1 = time.perf_counter()
    top1 = run_cli(cli_train, ["-d", "synthetic", "--synthetic-ids", "8", "-b", "16", "--epochs", "1", "--devices", "2",
                               "--logs-dir", str(logs), *cli_extra], device)
    sync(device)
    text = (logs / "log_train0.txt").read_text()
    visible = parallel.visible_devices(device)
    said = [line for line in text.splitlines() if line.startswith("--devices 2:")]
    log("dp_cli", seconds=time.perf_counter() - t1, top1=top1, visible_devices=visible, said=said,
        rank_logs=sorted(p.name for p in logs.glob("log_train0*.txt")), child_seconds=child_s,
        phase_seconds=time.perf_counter() - t0)
    check(np.isfinite(top1), f"cli.train --devices 2: rank-1 {top1}")
    if torch.device(device).type == "cuda" and visible == 1:
        check(parallel.auto_mesh(pairs=8, limit=2) == 1, "--devices 2 on one card asks for more than one rank")
        check(said and not (logs / "log_train0.p1.txt").exists(), "cli.train --devices 2 on one card did not say so")
    return ev["launches"]["minplus"]


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def zero_launches():
    for fn in ops.KERNELS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in ops.KERNELS.items()}


def run_cli(module, argv, device):
    """``module.main`` on ``argv`` in this process, with both TF32 flags
    turned on first: ``main`` must set its own precision policy (fp32, TF32
    off), which ``recording`` reads inside it and this checks after it;
    ``sys.stdout`` is restored after it (the CLI's tee logger replaces it)."""
    args = module.build_parser().parse_args([*argv, "--device", device])
    stdout = sys.stdout
    all_precision_flags(True)
    try:
        result = module.main(args)
    finally:
        sys.stdout = stdout
    check_fp32_policy(f"{module.__name__}.main", precision_flags())
    return result


@contextlib.contextmanager
def recording():
    """What a CLI run did, read from the classes it drives: each epoch's
    trainer stats and the state it ended with, the main thread's seconds in
    each ``AsyncCheckpointer.save``, each finished write (seconds, bytes),
    each ``Evaluator.evaluate`` result and each host protocol's
    ``(cmc, mAP)`` (``metrics.evaluate``, which ``--visual-from`` runs)."""
    rec = {"epochs": [], "saves": [], "writes": [], "evals": [], "protocols": [], "state": None}
    train, save, wait, evaluate = Trainer.train, AsyncCheckpointer.save, AsyncCheckpointer.wait, Evaluator.evaluate
    host_protocol = metrics.evaluate

    def rec_train(self, epoch, *a, **k):
        check_fp32_policy("Trainer.train inside a CLI", precision_flags())
        state, stats = train(self, epoch, *a, **k)
        rec["epochs"].append({"epoch": epoch, **stats})
        rec["state"] = state
        return state, stats

    def rec_save(self, *a, **k):
        save(self, *a, **k)
        rec["saves"].append(self.last_save_seconds)

    def rec_wait(self):
        pending = self._pending is not None
        wait(self)
        if pending:
            rec["writes"].append({"seconds": self.last_write_seconds, "bytes": self.last_bytes})

    def rec_evaluate(self, *a, **k):
        check_fp32_policy("Evaluator.evaluate inside a CLI", precision_flags())
        res = evaluate(self, *a, **k)
        rec["evals"].append(res)
        return res

    def rec_protocol(*a, **k):
        out = host_protocol(*a, **k)
        rec["protocols"].append(out)
        return out

    Trainer.train, AsyncCheckpointer.save, AsyncCheckpointer.wait, Evaluator.evaluate = (
        rec_train, rec_save, rec_wait, rec_evaluate)
    metrics.evaluate = rec_protocol
    try:
        yield rec
    finally:
        Trainer.train, AsyncCheckpointer.save, AsyncCheckpointer.wait, Evaluator.evaluate = (
            train, save, wait, evaluate)
        metrics.evaluate = host_protocol


def rerank_vs_plain(res):
    """Max abs difference between ``res.distmat`` and the same re-ranking of
    ``res``'s features with the plain min-sum."""
    plain = re_ranking(cosine_distance(res.qf, res.gf), _euclidean(res.qf, res.qf),
                       _euclidean(res.gf, res.gf), min_sum_fn=ops.minplus_plain)
    return float((plain - res.distmat).abs().max())


def step_probe(state, device, batch=16, frame=(64, 32), channels=3):
    """A copy of ``state`` steps at the CLI run's batch and frames: CUDA-event
    ms per step over 5 steps queued back to back (after one warm-up), and
    the kernel time of 2 more under ``torch.profiler``; the card is idle for
    the rest of a step."""
    probe = copy.deepcopy(state)
    step = make_train_step(device=device)
    clips = normalize(torch.randint(0, 256, (batch, 8, *frame, channels), dtype=torch.uint8, device=device))
    targets = np.repeat(np.arange(batch // 2), 2)
    step(probe, clips, targets, TRAIN_LR)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        step(probe, clips, targets, TRAIN_LR)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 5
    prof = device_profile(lambda: [step(probe, clips, targets, TRAIN_LR) for _ in range(2)], top=6)
    device_ms = prof["kernel_ms_total"] / 2
    return {"step_ms": step_ms, "kernel_ms_per_step": device_ms, "idle_share": 1 - device_ms / step_ms,
            "top": prof["top"]}


def phase_cli_train(device="cuda", extra=()):
    """``cli.train`` at full width over the synthetic catalog, 2 epochs with
    the re-ranked evaluation at the last; returns the state it ended with
    and the launch counts of the run."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    zero_launches()
    sync(device)
    with recording() as rec:
        t0 = time.perf_counter()
        top1 = run_cli(cli_train, [*CLI_TRAIN, "--epochs", "2", *extra], device)
        sync(device)
        seconds = time.perf_counter() - t0
    launches = read_launches()
    epochs = rec["epochs"]
    ckpt = CLI_DIR / "checkpoint.npz"
    tags = {json.loads(line)["tag"] for line in open(CLI_DIR / "train_log" / "scalars.jsonl")}
    probe = step_probe(rec["state"], device) if torch.device(device).type == "cuda" else None
    log("cli_train", seconds=seconds, top1=top1, launches=launches, steps_per_epoch=rec["state"].step // 2,
        step_probe=probe,
        warm_step_ms=epochs[-1]["batch_time"] * 1e3, epoch_stats=epochs,
        checkpoint_bytes=ckpt.stat().st_size, save_wait_s=rec["saves"], writes=rec["writes"],
        best_written=(CLI_DIR / "checkpoint_best.npz").exists(), scalar_tags=sorted(tags))
    if torch.device(device).type == "cuda":
        check(launches["minplus"] > 0, "cli.train's re-ranked evaluation did not launch the min-plus kernel")
    check([e["epoch"] for e in epochs] == [0, 1], f"cli.train ran epochs {[e['epoch'] for e in epochs]}")
    check(all(np.isfinite(e["loss"]) for e in epochs), "cli.train losses not finite")
    check(int(np.load(ckpt)["extra_epoch"]) == 2, "checkpoint.npz does not say epoch 2")
    check(len(rec["writes"]) == 2, f"{len(rec['writes'])} checkpoint writes, expected 2")
    check(tags == {"train/total_loss_step", "train/total_loss_avg"}, f"scalar tags {tags}")
    return rec["state"], launches


def phase_cli_resume(final, device="cuda", extra=()):
    """``checkpoint.npz`` into fresh train states on the card and the CPU,
    bit-equal to the state ``cli.train`` ended with; then one more epoch
    through ``--resume``."""
    ckpt = CLI_DIR / "checkpoint.npz"
    want = serialization.snapshot(final).leaves()
    paths = serialization.leaf_paths(final)
    args = cli_train.build_parser().parse_args([*CLI_TRAIN, *extra])
    result = {}
    for dev in dict.fromkeys((device, "cpu")):
        t0 = time.perf_counter()
        cnn, sia, unc = cli_train.build_models(args, tiny=args.tiny)
        state = init_train_state(cnn, sia, unc, final.luts["corr"].shape[0], num_feat=cnn.num_feat,
                                 device=dev)
        extras = load_train_state(state, str(ckpt))
        got = serialization.snapshot(state).leaves()
        differ = [p for p, a, b in zip(paths, got, want) if a.dtype != b.dtype or a.tobytes() != b.tobytes()]
        result[dev] = {"leaves": len(got), "differ": differ[:5], "seconds": time.perf_counter() - t0,
                       "epoch": int(extras["epoch"])}
        check(not differ and len(got) == len(want), f"resumed state on {dev} differs at {differ[:5]}")
        check(state.step == final.step, f"resumed step {state.step} vs {final.step}")
        del state, cnn, sia, unc
    zero_launches()
    with recording() as rec:
        t0 = time.perf_counter()
        run_cli(cli_train, [*CLI_TRAIN, "--epochs", "3", "--resume", str(ckpt), *extra], device)
        sync(device)
        seconds = time.perf_counter() - t0
    epochs = [e["epoch"] for e in rec["epochs"]]
    extra_epoch = int(np.load(ckpt)["extra_epoch"])
    log("cli_resume", bit_equal=result, resumed_epochs=epochs, extra_epoch=extra_epoch, seconds=seconds,
        launches=read_launches(), epoch_stats=rec["epochs"], writes=rec["writes"])
    check(epochs == [2], f"--resume trained epochs {epochs}, expected [2]")
    check(extra_epoch == 3, f"checkpoint after --resume says epoch {extra_epoch}")


def phase_cli_evaluate(device="cuda", extra=()):
    """``cli.evaluate`` on the best checkpoint (the last one when no
    evaluation beat rank-1 0) with re-ranking and ``--save-distmat``."""
    best = CLI_DIR / "checkpoint_best.npz"
    ckpt = best if best.exists() else CLI_DIR / "checkpoint.npz"
    dist = CLI_DIR / "distmat.npz"
    argv = ["-d", "synthetic", "--synthetic-ids", "32", "--seed", "0", "--rerank", "1",
            "--logs-dir", str(CLI_DIR), "--checkpoint", str(ckpt), "--save-distmat", str(dist), *extra]
    zero_launches()
    sync(device)
    with recording() as rec:
        t0 = time.perf_counter()
        top1 = run_cli(cli_evaluate, argv, device)
        sync(device)
        seconds = time.perf_counter() - t0
    launches = read_launches()
    res = rec["evals"][-1]
    saved = np.load(dist)
    err = rerank_vs_plain(res)
    log("cli_evaluate", seconds=seconds, checkpoint=ckpt.name, top1=top1, mAP=res.mAP, launches=launches,
        distmat_shape=list(saved["distmat"].shape), rerank_vs_plain_max_abs_diff=err)
    if torch.device(device).type == "cuda":
        check(launches["minplus"] > 0, "cli.evaluate --rerank 1 did not launch the min-plus kernel")
    check(bool(np.isfinite(saved["distmat"]).all()), "saved distmat not finite")
    check(np.array_equal(saved["distmat"], res.distmat.cpu().numpy()), "saved distmat is not the evaluator's")
    check(saved["distmat"].shape == (len(saved["q_pids"]), len(saved["g_pids"])) and bool(saved["rerank"]),
          "saved distmat's shape or flag")
    check(err <= KERNEL_TOL, f"cli.evaluate re-ranking, kernel vs plain min-sum: {err}")
    return launches


def phase_cli_mars(device="cuda", extra=(), frame=FRAME):
    """``cli.train -d mars`` for one epoch and ``cli.evaluate -d mars
    --rerank 1`` over a MARS layout written here, through the JPEG decode."""
    root, logs = BUILD / "chip_mars", BUILD / "chip_mars_run"
    for d in (root, logs):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    make_fake_mars.make_fake_mars(root, **FAKE_SIZES, height=frame[0], width=frame[1])
    write_s = time.perf_counter() - t0
    frames = jpeg_count(root)
    common = ["-d", "mars", "--data-dir", str(root), "--logs-dir", str(logs), *extra]
    with recording() as rec:
        t0 = time.perf_counter()
        top1_train = run_cli(cli_train, [*common, "-b", "16", "--epochs", "1"], device)
        sync(device)
        train_s = time.perf_counter() - t0
        zero_launches()
        t0 = time.perf_counter()
        top1 = run_cli(cli_evaluate, [*common, "--rerank", "1", "--seed", "0",
                                      "--checkpoint", str(logs / "checkpoint.npz")], device)
        sync(device)
        eval_s = time.perf_counter() - t0
    launches = read_launches()
    res = rec["evals"][-1]
    err = rerank_vs_plain(res)
    log("cli_mars", jpeg_frames=frames, frame=list(frame), write_seconds=write_s, train_seconds=train_s,
        evaluate_seconds=eval_s, train_steps=rec["state"].step, top1_train_eval=top1_train, top1=top1,
        query=int(res.qf.shape[0]), gallery=int(res.gf.shape[0]), launches=launches,
        native_jpeg=dict(jpeg.NATIVE_INFO), rerank_vs_plain_max_abs_diff=err)
    check(rec["state"].step >= 1 and np.isfinite(rec["epochs"][-1]["loss"]), "cli.train -d mars did not train")
    if torch.device(device).type == "cuda":
        check(launches["minplus"] > 0, "cli.evaluate -d mars --rerank 1 did not launch the min-plus kernel")
    check(bool(torch.isfinite(res.distmat).all()), "MARS distmat not finite")
    check(err <= KERNEL_TOL, f"cli.evaluate -d mars re-ranking, kernel vs plain min-sum: {err}")
    return launches


def jpeg_count(root):
    return sum(1 for _ in Path(root).rglob("*.jpg"))


def phase_fake_trees(frame=FRAME):
    """The port's fake-data tools write a DukeMTMC-VideoReID and a MARS tree
    under ``build/chip_fake`` (``FAKE_SIZES``); returns their roots."""
    shutil.rmtree(FAKE_DIR, ignore_errors=True)
    trees, stats = {}, {}
    for name, write in (("duke", make_fake_duke.make_fake_duke), ("mars", make_fake_mars.make_fake_mars)):
        t0 = time.perf_counter()
        trees[name] = write(FAKE_DIR / name, **FAKE_SIZES, height=frame[0], width=frame[1])
        stats[name] = {"write_seconds": time.perf_counter() - t0, "files": make_fake_mars.count_files(trees[name]),
                       "jpegs": jpeg_count(trees[name])}
    log("fake_trees", frame=list(frame), **stats)
    for name, st in stats.items():
        check(st["jpegs"] > 0, f"make_fake_{name} wrote no JPEG")
    return trees


def phase_prepare_real_data(trees):
    """``tools.prepare_real_data`` on each fake tree: the catalog builds, its
    split caches are written, every spot-decoded frame is 256x128x3 and the
    recipe names the port's entry points."""
    out = {}
    for name, root in trees.items():
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            res = prepare_real_data.main([name, "--data-dir", str(root)])
        text = buf.getvalue()
        caches = sorted(p.name for p in Path(root).glob("split_*.json"))
        out[name] = {"seconds": time.perf_counter() - t0, "catalog_seconds": res["catalog_seconds"],
                     "splits": res["splits"], "caches": caches, "decoded": len(res["decoded_shapes"]),
                     "routes": res["routes"], "native_error": res["native_error"]}
        check("catalog ok" in text, f"prepare_real_data {name}: no 'catalog ok'")
        check({"split_train.json", "split_query.json", "split_gallery.json"} <= set(caches),
              f"prepare_real_data {name}: split caches {caches}")
        check(res["decoded_shapes"] and all(s == (256, 128, 3) for s in res["decoded_shapes"]),
              f"prepare_real_data {name}: decoded shapes {set(res['decoded_shapes'])}")
        check("python -m grl_tpu_torch.cli.train" in res["recipe"], f"prepare_real_data {name}: recipe")
    log("prepare_real_data", **out)


def phase_cli_duke(root, device="cuda", extra=()):
    """``cli.train -d duke`` for one epoch and ``cli.evaluate -d duke --rerank
    1`` over the fake Duke tree, through the JPEG decode; the launch counts
    are zeroed before the evaluation and read after it."""
    shutil.rmtree(DUKE_RUN, ignore_errors=True)
    common = ["-d", "duke", "--data-dir", str(root), "--logs-dir", str(DUKE_RUN), *extra]
    with recording() as rec:
        t0 = time.perf_counter()
        top1_train = run_cli(cli_train, [*common, "-b", "16", "--epochs", "1"], device)
        sync(device)
        train_s = time.perf_counter() - t0
        zero_launches()
        sync(device)
        t0 = time.perf_counter()
        top1 = run_cli(cli_evaluate, [*common, "--rerank", "1", "--seed", "0",
                                      "--checkpoint", str(DUKE_RUN / "checkpoint.npz")], device)
        sync(device)
        eval_s = time.perf_counter() - t0
    launches = read_launches()
    res = rec["evals"][-1]
    err = rerank_vs_plain(res)
    log("cli_duke", train_seconds=train_s, evaluate_seconds=eval_s, train_steps=rec["state"].step,
        top1_train_eval=top1_train, top1=top1, mAP=res.mAP, query=int(res.qf.shape[0]),
        gallery=int(res.gf.shape[0]), distmat_shape=list(res.distmat.shape), launches=launches,
        native_jpeg=dict(jpeg.NATIVE_INFO), rerank_vs_plain_max_abs_diff=err)
    check(rec["state"].step >= 1 and np.isfinite(rec["epochs"][-1]["loss"]), "cli.train -d duke did not train")
    if torch.device(device).type == "cuda":
        check(launches["minplus"] >= 1, "cli.evaluate -d duke --rerank 1 did not launch the min-plus kernel")
    check(bool(torch.isfinite(res.distmat).all()), "Duke distmat not finite")
    check(err <= KERNEL_TOL, f"cli.evaluate -d duke re-ranking, kernel vs plain min-sum: {err}")
    return launches


PROFILE_LINKS = r"clamp|batch_norm|bn_fw|relu"  # kernels whose launching ops the describe profile names


def op_links(trace, pattern, steps, top=10):
    """Device kernels of ``trace`` whose name matches ``pattern``, by kernel
    and the chain of ops around its launch (innermost first, 3 deep):
    ``[kernel, ops, launches per step, ms per step]``."""
    rows = {}
    for name, us, _cat, op in trace.device:
        if not re.search(pattern, name):
            continue
        chain = []
        while op is not None and len(chain) < 3:
            chain.append(op.name)
            op = op.parent
        row = rows.setdefault((name[:80], " < ".join(chain) or "(no op)"), [0, 0.0])
        row[0] += 1
        row[1] += us
    return sorted(([k, ops_, n / steps, us / 1e3 / steps] for (k, ops_), (n, us) in rows.items()),
                  key=lambda r: -r[3])[:top]


def phase_profile(programs=PROFILES, extra=()):
    """``tools.profile_train_step`` in this process: each program traced for
    3 steps and reported by kernel category with the convolutions'
    roofline, then the saved trace reported again with ``--report-only``,
    which must print the same tables; the categories must sum to the
    kernel total."""
    for program, batch in programs:
        logdir = PROFILE_DIR / program
        shutil.rmtree(logdir, ignore_errors=True)
        argv = ["--program", program, "--batch", str(batch), "--steps", "3", "--roofline", "convolution",
                "--logdir", str(logdir), *extra]
        printed = []
        t0 = time.perf_counter()
        for more in ([], ["--report-only"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                res = profile_train_step.main([*argv, *more])
            printed.append(buf.getvalue())
            if not more:
                seconds = time.perf_counter() - t0
        total, cats = res["total_ms"], res["categories"]
        cat_sum = sum(c["ms"] for c in cats.values())
        conv = [{k: r[k] for k in ("name", "ms_step", "occ", "tflops_s", "pct_ops", "gbytes_s", "pct_bytes", "bound")}
                for r in res["roofline"]]
        meta = res["meta"]
        log("profile", program=program, batch=batch, steps=meta["steps"], seconds=seconds,
            trace_bytes=(logdir / "trace.json").stat().st_size, kernel_ms_total=total,
            kernel_ms_per_step=total / meta["steps"], category_sum_ms=cat_sum, linked=res["linked"],
            top_categories=sorted(([c, v["ms"] / meta["steps"], v["share"], v["count"]] for c, v in cats.items()),
                                  key=lambda r: -r[1])[:5],
            top_kernels=res["top"][:5], convolution_rows=conv,
            flops_ops=[meta["flops_ops"], meta["flops_ops_matched"]], nvidia_smi=meta.get("nvidia_smi"),
            dtype=meta["compute_dtype"])
        if program == "describe":
            # which ops launch the descriptor's clamps and BatchNorm's kernels
            log("profile_op_links", program=program, batch=batch,
                links=op_links(profile_train_step.Trace(str(logdir / "trace.json")), PROFILE_LINKS, meta["steps"]))
        check(res["on_device"] or not torch.cuda.is_available(), f"profile {program}: no device events")
        check(total > 0 and abs(cat_sum - total) <= 0.01 * total,
              f"profile {program}: categories sum to {cat_sum} ms of {total}")
        check(printed[0] == printed[1], f"profile {program}: --report-only printed other tables")
        check(conv and any(r["tflop"] > 0 for r in res["roofline"]),
              f"profile {program}: no convolution row with the profiler's flops")


def write_flow_layout(root, num_ids=FLOW_IDS, frames=FLOW_FRAMES, height=128, width=64, seed=0):
    """An iLIDS-VID layout with flow companions (``images/`` and ``others/``
    of the same names, JPEGs written with PIL), ``meta.json`` and
    ``splits.json``: the first half of the ids train, the rest are query
    (camera 0) and gallery (camera 1). Frames come from the synthetic
    catalog's per-id templates; each flow frame is its frame's horizontal
    difference, offset to mid-grey."""
    from PIL import Image

    from grl_tpu_torch.data.catalogs.synthetic import _template

    rng = np.random.RandomState(seed)
    for sub in ("images", "others"):
        (root / sub).mkdir(parents=True)
    identities = []
    for pid in range(num_ids):
        template, cams = _template(rng, height, width), []
        for cam in range(2):
            names = []
            for i in range(frames):
                img = np.clip((template * (0.9 + 0.2 * cam) + 0.08 * rng.randn(height, width, 3)) * 255, 0, 255)
                flow = np.clip(128 + 2 * (np.roll(img, 1, axis=1) - img), 0, 255)
                name = f"{pid:08d}_{cam:02d}_{i:04d}.jpg"
                Image.fromarray(img.astype(np.uint8)).save(root / "images" / name)
                Image.fromarray(flow.astype(np.uint8)).save(root / "others" / name)
                names.append(name)
            cams.append(names)
        identities.append(cams)
    (root / "meta.json").write_text(json.dumps({"identities": identities}))
    half = num_ids // 2
    test = list(range(half, num_ids))
    (root / "splits.json").write_text(json.dumps([{"trainval": list(range(half)), "query": test,
                                                    "gallery": test}]))
    return 2 * num_ids * 2 * frames


def tree_pixels(root):
    """{relative path: pixel bytes} of every PNG under ``root``."""
    from PIL import Image

    return {str(p.relative_to(root)): Image.open(p).tobytes() for p in sorted(root.rglob("*.png"))}


def phase_flow_cli(device="cuda", extra=(), frame=(128, 64)):
    """The ``--use-flow`` CLIs over an iLIDS-VID layout with flow companions:
    ``cli.train`` for one epoch with the re-ranked evaluation, ``cli.evaluate
    --rerank 1 --visual 1 --save-distmat`` under ``torch.profiler``,
    and ``--visual-from`` on the saved npz; launch counts zeroed before
    each CLI and read after. Returns the launches and the checkpoint."""
    from torch.profiler import ProfilerActivity, profile

    from grl_tpu_torch.engine import eval_items

    cuda = torch.device(device).type == "cuda"
    for d in (FLOW_DIR, FLOW_RUN):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    jpegs = write_flow_layout(FLOW_DIR, height=frame[0], width=frame[1])
    write_s = time.perf_counter() - t0
    common = ["-d", "ilidsvidsequence", "--data-dir", str(FLOW_DIR), "--use-flow", "--seq_len", "8",
              "--logs-dir", str(FLOW_RUN), *extra]
    out, launches = {}, {}

    zero_launches()
    sync(device)
    with recording() as rec:
        t0 = time.perf_counter()
        out["train_top1"] = run_cli(cli_train, [*common, "-b", "16", "--epochs", "1", "--rerank", "1"], device)
        sync(device)
        out["train_seconds"] = time.perf_counter() - t0
    launches["train"] = read_launches()["minplus"]
    state, epoch = rec["state"], rec["epochs"][-1]
    out["train_steps"] = state.step
    train_err = rerank_vs_plain(rec["evals"][-1])
    check(state.step >= 1 and np.isfinite(epoch["loss"]), "cli.train --use-flow did not train")
    check(state.models["cnn"].backbone.base.conv1.in_channels == 6, "cli.train --use-flow: conv1 is not 6-channel")
    probe = step_probe(state, device, frame=FLOW_FRAME, channels=6) if cuda else None
    del state, rec

    # the flow loader alone: clips decoded per second (2 JPEGs per frame)
    args = cli_train.build_parser().parse_args([*common, "-b", "16"])
    _, _, loader, _, _ = get_data("ilidsvidsequence", str(FLOW_DIR), 16, 8, args.seq_srd, args.workers,
                                  use_flow=True)
    t0 = time.perf_counter()
    decoded = sum(clips.shape[0] for clips, _, _ in loader)
    decode_s = time.perf_counter() - t0

    ckpt = FLOW_RUN / "checkpoint.npz"
    dist = FLOW_RUN / "distmat.npz"
    trace_file = FLOW_RUN / "trace" / "trace.json"
    trace_file.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    zero_launches()
    sync(device)
    with recording() as rec, profile(activities=activities) as prof:
        t0 = time.perf_counter()
        top1 = run_cli(cli_evaluate, [*common, "--rerank", "1", "--visual", "1", "--checkpoint", str(ckpt),
                                      "--save-distmat", str(dist)], device)
        sync(device)
        out["evaluate_seconds"] = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_file))
    launches["evaluate"] = read_launches()["minplus"]
    res = rec["evals"][-1]
    eval_err = rerank_vs_plain(res)
    kernels_traced = {e.get("name", "")[:60] for e in json.load(open(trace_file))["traceEvents"]
                      if "minplus_kernel" in e.get("name", "")}
    visual = FLOW_RUN / "visual"
    live_strips = tree_pixels(visual)
    query_dirs = sorted(p.name for p in visual.iterdir())
    q_items, _ = eval_items(*get_data("ilidsvidsequence", str(FLOW_DIR), 2, 8, args.seq_srd, 1, only_eval=True,
                                      use_flow=True)[3:])

    shutil.rmtree(visual)
    zero_launches()
    with recording() as rec:
        t0 = time.perf_counter()
        top1_from = run_cli(cli_evaluate, [*common, "--visual-from", str(dist)], device)
        out["visual_from_seconds"] = time.perf_counter() - t0
    launches["visual_from"] = read_launches()["minplus"]
    cmc_from, map_from = rec["protocols"][-1]
    again_strips = tree_pixels(visual)

    log("flow_cli", jpegs=jpegs, frame=list(frame), write_seconds=write_s, launches=launches,
        epoch_stats=epoch, step_probe=probe,
        loader_clips=decoded, loader_seconds=decode_s, loader_clips_per_s=decoded / decode_s,
        loader_jpegs_per_s=decoded * 8 * 2 / decode_s, top1=top1, mAP=res.mAP, top1_visual_from=top1_from,
        mAP_visual_from=map_from, query=int(res.qf.shape[0]), gallery=int(res.gf.shape[0]),
        descriptor_dim=int(res.qf.shape[1]), rerank_vs_plain_max_abs_diff={"train": train_err, "evaluate": eval_err},
        trace_bytes=trace_file.stat().st_size, trace_minplus_names=sorted(kernels_traced),
        strips=len(live_strips), query_dirs=len(query_dirs), **out)
    if cuda:
        check(launches["train"] > 0, "cli.train --use-flow --rerank 1 did not launch the min-plus kernel")
        check(launches["evaluate"] > 0, "cli.evaluate --use-flow --rerank 1 did not launch the min-plus kernel")
        check(bool(kernels_traced), "the trace of cli.evaluate --use-flow names no min-plus kernel")
    check(launches["visual_from"] == 0, "--visual-from launched a kernel")
    for what, err in (("train", train_err), ("evaluate", eval_err)):
        check(err <= KERNEL_TOL, f"cli.{what} --use-flow re-ranking, kernel vs plain min-sum: {err}")
    check(int(res.qf.shape[1]) == 3 * (2048 if "--tiny" not in extra else 128), "flow descriptor width")
    check(bool(torch.isfinite(res.distmat).all()) and 0.0 <= res.mAP <= 1.0, "flow evaluation out of range")
    check(len(query_dirs) == len(q_items) and all(
        (visual / d / "query.png").exists() and len(list((visual / d).glob("rank*.png"))) == 10 for d in query_dirs),
        f"--visual wrote {len(query_dirs)} query directories for {len(q_items)} queries")
    check(top1_from == top1 and abs(map_from - res.mAP) <= 1e-9 and np.array_equal(cmc_from, res.cmc),
          f"--visual-from rank-1 {top1_from} / mAP {map_from} vs the live run's {top1} / {res.mAP}")
    check(again_strips == live_strips, "--visual-from strips differ from the live run's")
    return launches, ckpt


def phase_flow_serve(ckpt, gen, device="cuda", extra=(), geo=SERVE):
    """``features --use-flow`` on query and gallery, ``rank --rerank`` (one
    launch, held against the plain min-sum), ``export-model --use-flow`` at
    the serve geometry with 6 channels, and one daemon ``describe`` of a
    batch of flow clips held against the in-process descriptor; a 3-channel
    clip sent to that daemon is refused."""
    common = ["-d", "ilidsvidsequence", "--data-dir", str(FLOW_DIR), "--use-flow", "--seq_len", "8",
              "--checkpoint", str(ckpt), *extra]
    path = {split: str(FLOW_RUN / f"features_{split}.npz") for split in ("query", "gallery")}
    t0 = time.perf_counter()
    for split in path:
        extract_main(["features", *common, "--split", split, "-o", path[split]], device)
    features_s = time.perf_counter() - t0
    zero_launches()
    sync(device)
    results = extract_main(["rank", "--query", path["query"], "--gallery", path["gallery"], "--topk", "10",
                            "--rerank", "-o", str(FLOW_RUN / "ranks.json")], device)
    sync(device)
    rank_launches = read_launches()["minplus"]
    qf, gf = (torch.from_numpy(np.load(path[s])["features"]).to(device) for s in ("query", "gallery"))
    with torch.inference_mode():
        plain = re_ranking(cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf),
                           min_sum_fn=ops.minplus_plain).cpu().numpy()
    idx, scores = answer({"results": results})
    agree = topk_agreement(idx, scores, plain)

    model = FLOW_RUN / "model_flow.npz"
    (h, w), b = geo["frame"], geo["batch"]
    classes = json.loads((FLOW_DIR / "splits.json").read_text())[0]["trainval"]
    t0 = time.perf_counter()
    meta = extract_main(["export-model", "--checkpoint", str(ckpt), "--num-classes", str(len(classes)), "--use-flow",
                         "--batch", str(b), "--seq_len", str(geo["seq_len"]), "--height", str(h), "--width", str(w),
                         "-o", str(model), *extra], device)
    export_s = time.perf_counter() - t0
    args = cli_train.build_parser().parse_args(["-d", "ilidsvidsequence", "--use-flow", *extra])
    cnn, sia, unc = cli_train.build_models(args, tiny=args.tiny)
    state = init_train_state(cnn, sia, unc, len(classes), num_feat=cnn.num_feat, device=device)
    load_train_state(state, str(ckpt))
    clips = np.random.RandomState(2).randint(0, 256, (b, geo["seq_len"], h, w, 6), np.uint8)
    np.savez(FLOW_RUN / "clips.npz", clips=clips)
    with torch.inference_mode():
        want = make_descriptor_fn(cnn.eval(), sia.eval())(torch.from_numpy(clips).to(device)).cpu().numpy()
    del state, cnn, sia, unc
    artifact = artifact_check(model, clips, device)
    sock = str(FLOW_RUN / "d.sock")
    if len(sock) > 100:  # AF_UNIX paths are short
        sock = os.path.relpath(sock)
    with loaded_artifacts() as loaded, daemon(["--model", str(model)], device, sock) as c:
        ping = c.ping()
        mark = dispatch_mark(c, loaded)
        t0 = time.perf_counter()
        got = c.describe(str(FLOW_RUN / "clips.npz"))["features"]
        describe_s = time.perf_counter() - t0
        try:
            c.describe(clips[:1, ..., :3])
            refused = None
        except ServeError as e:
            refused = str(e)
        graph = graph_dispatches(mark, dispatch_mark(c, loaded), loaded, device, "flow daemon")
    desc_err = float(np.abs(got - want).max())
    log("flow_serve", graph=graph, queries=int(qf.shape[0]), gallery=int(gf.shape[0]), features_s=features_s,
        rank_launches=rank_launches, vs_plain_min_sum=agree, export_seconds=export_s, meta=meta,
        artifact_bytes=model.stat().st_size, artifact=artifact, describe_clips=b, describe_seconds=describe_s,
        describe_vs_modules_max_abs=desc_err, three_channel_refusal=refused)
    if torch.device(device).type == "cuda":
        check(rank_launches == 1, f"rank --rerank on flow features launched the kernel {rank_launches} times")
    check(len(results) == qf.shape[0] and np.isfinite(scores).all(), "flow rank --rerank results")
    check(agree["max_abs_diff"] <= KERNEL_TOL, f"flow rank --rerank vs plain min-sum: {agree}")
    check(meta["channels"] == 6 and ping["channels"] == 6, f"flow artifact channels {meta['channels']}")
    check(got.dtype == np.float32 and desc_err <= 1e-4, f"flow daemon describe vs the modules: {desc_err}")
    check(refused is not None and "exported for" in refused, f"3-channel clip to the flow daemon: {refused}")
    check(c.bye["ok"], "flow daemon shutdown")
    return rank_launches


def phase_flow_models(gen, device="cuda"):
    """Card against CPU at full width on 2 clips of 8 frames at 256x128:
    ``resnet50_grl`` on a 6-channel trunk (the descriptor, within
    ``MODEL_TOL``), ``ResNetBaseline`` and ``TwoStreamBaseline`` (both
    heads) with their warm ms per 32 clips, and ``visualize_attention``'s
    GCE masks (the PNG grid only where matplotlib imports)."""
    from grl_tpu_torch.engine import visualize

    out = {}
    trunk = models.resnet50_trunk(last_stride=1, in_channels=6)
    cnn = models.create("resnet50_grl", device=device, seed=0, trunk=trunk)
    sia = models.create("siamese", device=device, seed=1, input_num=cnn.num_feat, output_num=512)
    clips = torch.randint(0, 256, (2, 8, *FLOW_FRAME, 6), dtype=torch.uint8, device=device, generator=gen)
    calibrate_bn(cnn, lambda: cnn(normalize(clips)))
    calibrate_bn(sia, lambda: sia.self_attention(cnn(normalize(clips))[1]))
    cnn_cpu, sia_cpu = copy.deepcopy(cnn).cpu(), copy.deepcopy(sia).cpu()
    with torch.inference_mode():
        d_card = make_descriptor_fn(cnn, sia)(clips).cpu()
        d_cpu = make_descriptor_fn(cnn_cpu, sia_cpu)(clips.cpu())
    out["grl_flow"] = {"descriptor_dim": int(d_card.shape[1]), "max_abs_diff": float((d_card - d_cpu).abs().max()),
                       "ms_per_32_clips": descriptor_ms(cnn, sia, clips[:1].expand(32, -1, -1, -1, -1).contiguous())}
    check(tuple(d_card.shape) == (2, 6144) and bool(torch.isfinite(d_card).all()), "flow descriptor shape/finite")
    check(out["grl_flow"]["max_abs_diff"] <= MODEL_TOL, f"flow descriptor card vs CPU {out['grl_flow']}")

    t0 = time.perf_counter()
    masks_card = visualize.attention_masks(cnn, clips)
    masks_cpu = visualize.attention_masks(cnn_cpu, clips.cpu())
    out["attention"] = {"shape": list(masks_card.shape), "max_abs_diff": float(np.abs(masks_card - masks_cpu).max())}
    if importlib.util.find_spec("matplotlib") is not None:
        visualize.visualize_attention(cnn, clips.cpu().numpy(), str(FLOW_RUN / "attention"))
        out["attention"]["rendered"] = sorted(p.name for p in (FLOW_RUN / "attention").glob("*.png"))
    else:
        out["attention"]["rendered"] = "matplotlib absent: masks checked, no PNG grid"
    out["attention"]["seconds"] = time.perf_counter() - t0
    check(masks_card.shape == (2, 8, FLOW_FRAME[0] // 16, FLOW_FRAME[1] // 16), f"attention masks {masks_card.shape}")
    check(out["attention"]["max_abs_diff"] <= MODEL_TOL, f"attention masks card vs CPU {out['attention']}")
    del cnn, sia, cnn_cpu, sia_cpu
    torch.cuda.empty_cache()

    x = normalize(clips)
    for name, channels in (("resnet50", 3), ("two_stream", 6)):
        model = models.create(name, device=device, seed=0)
        inp = x[..., :channels]
        calibrate_bn(model, lambda: model(inp))
        with torch.inference_mode():
            card = model(inp)
            cpu = copy.deepcopy(model).cpu()(inp.cpu())
            big = x[:1, ..., :channels].expand(32, -1, -1, -1, -1).contiguous()
            ms = cuda_ms(lambda: model(big), reps=3)
        errs = [float((a.cpu() - b).abs().max()) for a, b in zip(card, cpu)]
        out[name] = {"emb_shape": list(card[0].shape), "raw_shape": list(card[1].shape),
                     "max_abs_diff_emb_raw": errs, "ms_per_32_clips": ms}
        check(max(errs) <= MODEL_TOL, f"{name} card vs CPU {errs}")
        check(card[1].shape[-1] == (4096 if name == "two_stream" else 2048), f"{name} raw width")
        del model, big
        torch.cuda.empty_cache()
    log("flow_models", **out)


def unit_rows(rows, dim, device, gen):
    x = torch.randn(rows, dim, device=device, generator=gen)
    return x / x.norm(dim=1, keepdim=True)


def memory_mark(device):
    """Allocated bytes now, with the peak counter reset (0 off the card)."""
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def staged_features(device, q=STAGED_Q, extra_g=STAGED_EXTRA_G, dim=6144):
    """``rerank_staged``'s random unit features (queries, query ∪ gallery),
    from a generator of their own: every process that calls this on one
    kind of device gets the same ones."""
    gen = torch.Generator(device=device).manual_seed(STAGED_SEED)
    qf = unit_rows(q, dim, device, gen)
    return qf, torch.cat([qf, unit_rows(extra_g, dim, device, gen)])  # gallery = query ∪ gallery


def phase_rerank_staged(device="cuda", q=STAGED_Q, extra_g=STAGED_EXTRA_G, dim=6144, force=False):
    """Re-ranking past the staged builder's cut (n = 19960 > 16384): the
    staged builder as ``re_ranking`` picks it, the one-program builder (the
    cut raised to n) and the staged builder with the plain min-sum, on
    random unit features; each one's seconds, launches and peak memory.
    ``force`` shrinks the cut to 0 (a rehearsal below it). Returns
    the launches, the staged builder's numbers, and its result (which
    ``phase_sharded`` holds the row-sharded builder to)."""
    cuda = torch.device(device).type == "cuda"
    qf, gf = staged_features(device, q, extra_g, dim)
    n = q + gf.shape[0]
    if not force:
        check(n > 16384, f"n = {n} does not reach the staged builder")

    def run(cut=0 if force else rerank_mod.ONE_PROGRAM_MAX, **kw):
        box = rerank_inputs(qf, gf)
        at_entry = memory_mark(device)
        zero_launches()
        t0 = time.perf_counter()
        with one_program_max(cut):
            out = re_ranking(inputs_box=box, **kw)
        sync(device)
        info = {"seconds": time.perf_counter() - t0, "launches": read_launches()["minplus"],
                "nearest_launches": read_launches()["nearest"],
                "at_entry_gib": at_entry / 2**30,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
        return out, info

    run()  # warm: the first call pays library set-up
    staged, staged_info = run()
    one, one_info = run(cut=n)
    plain, plain_info = run(min_sum_fn=ops.minplus_plain)
    err_one = float((staged - one).abs().max())
    err_plain = float((staged - plain).abs().max())
    slabs = -(-n // rerank_mod._MINPLUS_CHUNK)
    log("rerank_staged", queries=q, gallery=int(gf.shape[0]), n=n, dim=dim, staged=staged_info,
        one_program=one_info, staged_plain_min_sum=plain_info, staged_vs_one_program_max_abs_diff=err_one,
        staged_vs_plain_max_abs_diff=err_plain, slabs=slabs)
    check(tuple(staged.shape) == (q, gf.shape[0]), f"staged shape {tuple(staged.shape)}")
    check(bool(torch.isfinite(staged).all()), "staged re-ranking not finite")
    if cuda:
        check(staged_info["launches"] == slabs, f"staged builder launched {staged_info['launches']}, "
                                                f"expected one per slab ({slabs})")
        check(one_info["launches"] == 1 and plain_info["launches"] == 0, "one-program / plain launches")
        nearest = (staged_info["nearest_launches"], one_info["nearest_launches"], plain_info["nearest_launches"])
        check(nearest == (0, 1, 0), f"nearest launches (staged, one-program, staged plain): {nearest}")
    check(err_one <= KERNEL_TOL, f"staged vs one-program builder: {err_one}")
    check(err_plain <= KERNEL_TOL, f"staged builder, kernel vs plain min-sum: {err_plain}")
    return staged_info["launches"], staged_info, staged


def sharded_rank(opts):
    """One rank of the sharded phases (``parallel.launch`` over gloo): its
    mesh, the precision policy, ``sharded_rank_job``."""
    set_precision()
    return sharded_rank_job(parallel.data_mesh(), opts)


def sharded_rank_job(mesh, opts):
    """The sharded phases' work on one rank (``phase_sharded``)."""
    device = mesh.device
    out = {"rank": mesh.rank, "mesh": repr(mesh), "backend": torch.distributed.get_backend()}

    # rerank_sharded: rerank_staged's features, the row-sharded builder
    qf, gf = staged_features(device, *opts["staged_shape"])
    q = qf.shape[0]
    slabs, slab_errs = [], {}

    def checked(a, b):
        """The kernel on one slab, each slab shape also held to the plain min-sum."""
        s = ops.minplus(a, b)
        slabs.append([a.shape[0], b.shape[0], b.shape[1]])
        if b.shape[0] not in slab_errs:
            slab_errs[b.shape[0]] = float((s - ops.minplus_plain(a, b)).abs().max())
        return s

    def run(min_sum_fn):
        box = [rerank_columns(qf, gf, mesh)]
        at_entry = memory_mark(device)
        t0 = time.perf_counter()
        dist = re_ranking(inputs_box=box, query_num=q, mesh=mesh, min_sum_fn=min_sum_fn)
        sync(device)
        return dist, {"seconds": time.perf_counter() - t0, "at_entry_gib": at_entry / 2**30,
                      "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None}

    checked_dist = run(checked)[0].cpu()
    torch.distributed.barrier()
    zero_launches()
    dist, info = run(ops.minplus)
    info["launches"] = read_launches()["minplus"]
    one_card = torch.from_numpy(np.load(opts["staged_path"])).to(device)
    out["rerank"] = {**info, "slabs": slabs, "slab_vs_plain_max_abs_err": slab_errs,
                     "vs_one_card_max_abs_diff": float((dist - one_card).abs().max()),
                     "checked_run_vs_one_card_max_abs_diff": float((checked_dist.to(device) - one_card).abs().max()),
                     "finite": bool(torch.isfinite(dist).all()), "shape": list(dist.shape),
                     "rows": list(parallel.row_block(q + gf.shape[0], mesh))}
    del qf, gf, dist, one_card, checked_dist
    empty_cache(device)

    # eval_sharded: the slice's catalog striped over the ranks, the tail sharded
    frame, tiny = tuple(opts["frame"]), opts["tiny"]
    cnn, sia, unc = dp_modules(device, tiny)
    if mesh.rank == 0:
        gen = torch.Generator(device=device).manual_seed(8)
        calibrate_grl(cnn, sia, unc, torch.randint(0, 256, (4, 8, *frame, 3), dtype=torch.uint8, device=device,
                                                   generator=gen))
    for m in (cnn, sia):
        parallel.replicate(m, mesh)  # rank 0's calibrated statistics on every rank
    ev = SyntheticVideoReID(num_train_ids=0, num_test_ids=24, tracklets_per_id=2, num_cams=2, frames_range=(8, 40),
                            height=frame[0], width=frame[1], seed=0)
    dense = lambda items: ClipLoader(ClipDataset(items, 8, "dense", *frame), batch_size=1, workers=4)
    if mesh.rank == 0:
        one = Evaluator(cnn, sia, micro_batch=32, rerank=True, device=device).evaluate(dense(ev.query),
                                                                                      dense(ev.gallery))
        out["one_card"] = {"distmat": one.distmat.cpu().numpy(), "rank1": float(one.cmc[0]), "mAP": one.mAP}
    meta = {"query": parallel.eval_catalog_meta(ev.query), "gallery": parallel.eval_catalog_meta(ev.gallery)}
    stripes = [parallel.stripe_catalog(items, mesh.rank, mesh.size)[0] for items in (ev.query, ev.gallery)]
    torch.distributed.barrier()  # both ranks start together (rank 0 ran the one-card evaluation)
    zero_launches()
    sync(device)
    t0 = time.perf_counter()
    res = Evaluator(cnn, sia, micro_batch=32, rerank=True, device=device, mesh=mesh).evaluate(
        dense(stripes[0]), dense(stripes[1]), multihost=meta)
    sync(device)
    out["evaluate"] = {"seconds": time.perf_counter() - t0, "launches": read_launches()["minplus"],
                       "distmat": res.distmat.cpu().numpy(), "rank1": float(res.cmc[0]), "mAP": res.mAP,
                       "query": len(ev.query), "gallery": len(ev.gallery), "stripe": len(stripes[0])}
    return out


def slab_bounds(shape):
    """The data-sheet bound of one min-plus slab ``(m, n, k)``: ``(ms, by)``."""
    m, n, k = shape
    ops_ms = 2.0 * m * n * k / PEAK_FP32_OPS * 1e3
    bytes_ms = 4.0 * (m * k + n * k + m * n) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_sharded(staged, staged_info, device="cuda", staged_shape=(STAGED_Q, STAGED_EXTRA_G, 6144), frame=FRAME,
                  tiny=False):
    """``rerank_sharded`` and ``eval_sharded``: two gloo ranks sharing this
    card (``parallel.launch`` groups ranks that outnumber the cards over
    gloo: NCCL refuses two ranks on one card). ``rerank_sharded``: the row-sharded builder on
    ``rerank_staged``'s features, held to the one-card staged result
    ``staged``, each rank's peak memory beside the one-card staged peak,
    its launches and slab shapes, each slab shape held to the plain
    min-sum. ``eval_sharded``: the slice's catalog striped over the ranks
    and re-ranked through the sharded tail against one card. Returns the
    launches of each path, by rank."""
    cuda = torch.device(device).type == "cuda"
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    SHARDED_DIR.mkdir(parents=True)
    staged_path = str(SHARDED_DIR / "staged.npy")
    np.save(staged_path, staged.cpu().numpy())
    t0 = time.perf_counter()
    ranks = parallel.launch(sharded_rank, {"staged_path": staged_path, "staged_shape": list(staged_shape),
                                           "frame": list(frame), "tiny": tiny}, SHARDED_RANKS, device,
                            workdir=SHARDED_DIR, timeout=600)
    seconds = time.perf_counter() - t0
    n = staged_shape[0] * 2 + staged_shape[1]
    rr = [r["rerank"] for r in ranks]
    shapes = sorted({tuple(s) for r in rr for s in r["slabs"]}, reverse=True)
    log("rerank_sharded", ranks=SHARDED_RANKS, mesh=[r["mesh"] for r in ranks], backend=ranks[0]["backend"], n=n,
        by_rank=[{k: v for k, v in r.items() if k != "slabs"} for r in rr],
        slab_shapes_by_rank=[r["slabs"] for r in rr],
        slab_bounds={"x".join(map(str, s)): dict(zip(("bound_ms", "bound_by"), slab_bounds(s))) for s in shapes},
        one_card_staged_peak_gib=staged_info["peak_gib"],
        peak_ratio=[r["peak_gib"] / staged_info["peak_gib"] for r in rr] if cuda else None,
        one_card_staged_seconds=staged_info["seconds"], phase_seconds=seconds, tol=KERNEL_TOL)
    for r in rr:
        check(r["finite"] and r["shape"] == list(staged.shape), f"sharded result {r['shape']}, finite {r['finite']}")
        for what in ("vs_one_card_max_abs_diff", "checked_run_vs_one_card_max_abs_diff"):
            check(r[what] <= KERNEL_TOL, f"row-sharded vs one-card staged builder, {what}: {r[what]}")
        check(max(r["slab_vs_plain_max_abs_err"].values()) <= KERNEL_TOL,
              f"min-plus slab vs plain min-sum: {r['slab_vs_plain_max_abs_err']}")
        if cuda:
            check(r["launches"] == len(r["slabs"]) >= 1, f"rank launches {r['launches']}, slabs {len(r['slabs'])}")
            check(r["peak_gib"] < staged_info["peak_gib"],
                  f"rank peak {r['peak_gib']:.3f} GiB not below the one-card staged peak {staged_info['peak_gib']:.3f}")

    one = ranks[0]["one_card"]
    ev = [r["evaluate"] for r in ranks]
    errs = [float(np.abs(e["distmat"] - one["distmat"]).max()) for e in ev]
    log("eval_sharded", ranks=SHARDED_RANKS, query=ev[0]["query"], gallery=ev[0]["gallery"],
        stripe=[e["stripe"] for e in ev], seconds=[e["seconds"] for e in ev], launches=[e["launches"] for e in ev],
        rank1=[e["rank1"] for e in ev], mAP=[e["mAP"] for e in ev], one_card_rank1=one["rank1"],
        one_card_mAP=one["mAP"], distmat_max_abs_diff=errs, tol=KERNEL_TOL)
    for e, err in zip(ev, errs):
        check(np.isfinite(e["distmat"]).all() and err <= KERNEL_TOL, f"sharded evaluation distmat vs one card: {err}")
        check(e["rank1"] == one["rank1"] and abs(e["mAP"] - one["mAP"]) <= KERNEL_TOL,
              f"sharded rank-1/mAP {e['rank1']}/{e['mAP']} vs one card {one['rank1']}/{one['mAP']}")
        if cuda:
            check(e["launches"] >= 1, f"min-plus launches on a rank of the sharded evaluation: {e['launches']}")
    return {"rerank_sharded": [r["launches"] for r in rr], "eval_sharded": [e["launches"] for e in ev]}


def extract_main(argv, device):
    """``cli.extract.main`` on ``argv`` in this process (``--device`` goes
    before the subcommand), with both TF32 flags turned on first; the
    policy ``main`` sets is checked after it."""
    all_precision_flags(True)
    result = cli_extract.main(cli_extract.build_parser().parse_args(["--device", device, *argv]))
    check_fp32_policy(f"cli.extract {argv[0]}", precision_flags())
    return result


def median_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def daemon(argv, device, sock):
    """``serve --listen unix:<sock>`` in this process, on a thread; yields a
    connected ``ServeClient``; on exit sends ``shutdown`` (its response in
    ``client.bye``) and joins the daemon, re-raising what it raised."""
    result = {}

    def target():
        try:
            result["served"] = cli_extract.main(cli_extract.build_parser().parse_args(
                ["--device", device, "serve", *argv, "--listen", f"unix:{sock}"]))
        except BaseException as e:  # noqa: BLE001 — re-raised in the main thread
            result["error"] = e

    if os.path.exists(sock):
        os.unlink(sock)
    all_precision_flags(True)  # the daemon's main sets its own policy
    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    deadline = time.time() + 600
    while not os.path.exists(sock):
        if "error" in result:
            raise result["error"]
        check(thread.is_alive() and time.time() < deadline, "serve daemon did not start listening")
        time.sleep(0.05)
    check_fp32_policy("serve", precision_flags())
    client = ServeClient.connect(f"unix:{sock}", timeout=600)
    try:
        yield client
    finally:
        try:
            client.bye = client.shutdown()
        except ServeError as e:
            client.bye = {"ok": False, "error": str(e)}
        thread.join(timeout=60)
        if thread.is_alive():
            faulthandler.dump_traceback(all_threads=True)  # where it hangs, on stderr
    check(not thread.is_alive(), "serve daemon did not stop after shutdown")
    if "error" in result:
        raise result["error"]


def topk_rows(dist, k):
    """Top-k of -dist per row in the daemon's order: (indices, scores)."""
    scores, idx = rerank_mod.top_k(-dist, k)
    return idx.cpu().numpy(), scores.cpu().numpy()


def topk_agreement(idx, scores, ref):
    """A daemon's top-k (gallery indices, scores) against reference
    distances ``ref`` (q, g): ``max_abs_diff`` is the larger of each
    score's distance from the reference at its own index and from the
    reference's own k-th best, so matches that differ from the reference's
    can only be entries within it of each other (near-ties, which fp32
    sums in another order may swap); ``queries_equal`` counts the queries
    whose matches are the reference's exactly."""
    k = idx.shape[1]
    ref_idx, ref_scores = topk_rows(torch.from_numpy(ref), k)
    return {"max_abs_diff": max(float(np.abs(scores + np.take_along_axis(ref, idx, axis=1)).max()),
                                float(np.abs(scores - ref_scores).max())),
            "queries_equal": int((idx == ref_idx).all(axis=1).sum()), "queries": int(idx.shape[0])}


def answer(resp):
    """A rank response's matches: (gallery indices, scores) per query."""
    return (np.array([[m["gallery"] for m in r["matches"]] for r in resp["results"]]),
            np.array([[m["score"] for m in r["matches"]] for r in resp["results"]]))


def concurrent_describes(address, clips_paths, requests=4):
    """One client per npz of ``clips_paths``, all describing at once,
    ``requests`` times each; returns every answer's features. A request of
    1¼ batches leaves a ¼-batch tail that packs with another client's
    ¼-batch request queued behind its full chunk."""
    got, errors = [], []

    def client(path):
        try:
            with ServeClient.connect(address, timeout=600) as c:
                for _ in range(requests):
                    got.append(c.describe(str(path))["features"])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(path,)) for path in clips_paths]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    check(not any(t.is_alive() for t in threads), "concurrent describe clients did not finish")
    if errors:
        raise errors[0]
    return got


def phase_serve(gen, device="cuda", extra=(), geo=SERVE):
    """``export-model`` of ``cli_train``'s checkpoint at full width, then two
    ``serve --listen unix:`` daemons in this process driven by the port's
    ``ServeClient``: the padded re-ranking route at capacity 11310 and the
    staged route at capacity 16384, each rerank answer held against
    ``re_ranking`` on the unpadded index and the daemon's own geometry with
    the plain min-sum; launch counts zeroed just before each rerank request
    and read just after."""
    cuda = torch.device(device).type == "cuda"
    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    sock = str(SERVE_DIR / "d.sock")
    if len(sock) > 100:  # AF_UNIX paths are short
        sock = os.path.relpath(sock)
    ckpt = CLI_DIR / "checkpoint.npz"
    model = SERVE_DIR / "model.npz"
    (h, w), b, k = geo["frame"], geo["batch"], 10
    t0 = time.perf_counter()
    meta = extract_main(["export-model", "--checkpoint", str(ckpt), "--num-classes", str(SYNTH_IDS),
                         "--batch", str(b), "--seq_len", str(geo["seq_len"]), "--height", str(h),
                         "--width", str(w), "-o", str(model), *extra], device)
    export_s = time.perf_counter() - t0
    dim = meta["dim"]

    # the same modules from the checkpoint, described directly on the device
    args = cli_train.build_parser().parse_args([*CLI_TRAIN, *extra])
    cnn, sia, unc = cli_train.build_models(args, tiny=args.tiny)
    state = init_train_state(cnn, sia, unc, SYNTH_IDS, num_feat=cnn.num_feat, device=device)
    load_train_state(state, str(ckpt))
    describe = make_descriptor_fn(cnn.eval(), sia.eval())
    rng = np.random.RandomState(0)
    clips = rng.randint(0, 256, (geo["clips"], geo["seq_len"], h, w, 3), np.uint8)
    np.savez(SERVE_DIR / "clips.npz", clips=clips)
    np.savez(SERVE_DIR / "clips_5q.npz", clips=clips[: b + b // 4])  # 1¼ batches
    np.savez(SERVE_DIR / "clips_1q.npz", clips=clips[: b // 4])
    with torch.inference_mode():
        want = torch.cat([describe(torch.from_numpy(clips[i : i + b]).to(device))
                          for i in range(0, len(clips), b)]).cpu().numpy()
    del state, cnn, sia, unc
    artifact = artifact_check(model, clips[:b], device)

    feats = unit_rows(geo["gallery"] + geo["add"] + geo["queries"], dim, device, gen).cpu().numpy()
    gallery, added, queries = np.split(feats, [geo["gallery"], geo["gallery"] + geo["add"]])
    ids = rng.randint(0, 1000, geo["gallery"] + geo["add"])
    cams = rng.randint(0, 6, geo["gallery"] + geo["add"])
    np.savez(SERVE_DIR / "gallery.npz", features=gallery, pids=ids[: geo["gallery"]],
             camids=cams[: geo["gallery"]])
    common = ["--model", str(model), "--rerank-queries", str(geo["queries"]), "--topk", str(k), "--warmup"]

    def routes(c, info):
        """Plain and re-ranked rank on one daemon: answers, latencies, launches."""
        info["rank_ms"] = median_ms(lambda: c.rank(features=queries, topk=k))
        zero_launches()
        sync(device)
        rr = c.rank(features=queries, topk=k, rerank=True)
        sync(device)
        info["launches"], info["nearest_launches"] = read_launches()["minplus"], read_launches()["nearest"]
        info["rerank_ms"] = median_ms(lambda: c.rank(features=queries, topk=k, rerank=True))
        if cuda:  # device time of one request of each kind (the daemon's thread is in this process)
            info["rank_profile"] = device_profile(lambda: c.rank(features=queries, topk=k), top=4)
            info["rerank_profile"] = device_profile(
                lambda: c.rank(features=queries, topk=k, rerank=True), top=8)
        check(rr["reranked"] and "warning" not in rr, f"rerank response {sorted(rr)}")
        return answer(rr)

    padded, staged = {}, {}
    zero_launches()
    t0 = time.perf_counter()
    with loaded_artifacts() as loaded, daemon(["--gallery", str(SERVE_DIR / "gallery.npz"), "--capacity",
                                               str(geo["capacity"]), *common], device, sock) as c:
        padded["ready_s"] = time.perf_counter() - t0
        padded["warm_up_nearest_launches"] = read_launches()["nearest"]  # the re-ranked warm-up's
        ping = c.ping()
        mark = dispatch_mark(c, loaded)
        check(ping["platform"] == torch.device(device).type and ping["rerank"] and not ping["rerank_staged"]
              and ping["gallery"] == geo["gallery"] and ping["rerank_queries"] == b, f"ping {ping}")
        t0 = time.perf_counter()
        got = c.describe(str(SERVE_DIR / "clips.npz"))["features"]
        describe_s = time.perf_counter() - t0
        if cuda:
            padded["describe_profile"] = device_profile(lambda: c.describe(str(SERVE_DIR / "clips.npz")), top=4)
        desc_err = float(np.abs(got - want).max())
        add = c.add(features=added, pids=ids[geo["gallery"]:], camids=cams[geo["gallery"]:])
        check(add["gallery"] == geo["capacity"], f"add {add}")
        rr_padded = routes(c, padded)
        conc = concurrent_describes(f"unix:{sock}", [SERVE_DIR / "clips_5q.npz", SERVE_DIR / "clips_1q.npz"])
        conc_err = max(float(np.abs(f - want[: len(f)]).max()) for f in conc)
        graph = graph_dispatches(mark, dispatch_mark(c, loaded), loaded, device, "serve")
        stats = c.stats()
        c.save(out=str(SERVE_DIR / "index.npz"))
    check(c.bye["ok"], "shutdown")
    t0 = time.perf_counter()
    with daemon(["--gallery", str(SERVE_DIR / "index.npz"), "--capacity", str(geo["staged_capacity"]),
                 *common], device, sock) as c:
        staged["ready_s"] = time.perf_counter() - t0
        ping_staged = c.ping()
        check(ping_staged["rerank_staged"] and ping_staged["gallery"] == geo["capacity"], f"ping {ping_staged}")
        rr_staged = routes(c, staged)
    devices = serve_devices(common, geo, queries, k, device, sock, rr_staged)

    # references on the device, from each daemon's own distance matrices
    # (the query-gallery block is a squared cosine distance, whose smallest
    # entries, the queries' nearest items, are ordered by the rounding of
    # the distance product; another product shape may pick other items):
    # re_ranking over their unpadded valid slices (kernel) with the zero
    # diagonal the padded builders give every item (``_euclidean``'s
    # self-distance is fp32 noise, up to ~3e-4 on the card, which can rank
    # a query below its most orthogonal gallery items: "noisy_diagonal"),
    # and the whole padded geometry with the plain min-sum
    with torch.inference_mode():
        gf = torch.from_numpy(np.load(SERVE_DIR / "index.npz")["features"]).to(device)
        qf = torch.from_numpy(queries).to(device)
        nq, n = qf.shape[0], gf.shape[0]
        refs = {}
        for name, cap in (("padded", geo["capacity"]), ("staged", geo["staged_capacity"])):
            buf = torch.zeros((cap + 256, dim), device=device)
            buf[:n] = gf
            qpad = torch.zeros((b, dim), device=device)
            qpad[:nq] = qf
            qg, qq, gg = cosine_distance(qpad, buf), _euclidean(qpad, qpad), _euclidean(buf, buf)
            noisy = re_ranking(qg[:nq, :n], qq[:nq, :nq], gg[:n, :n])
            qq_v, gg_v = qq[:nq, :nq].clone(), gg[:n, :n].clone()
            qq_v.fill_diagonal_(0.0)
            gg_v.fill_diagonal_(0.0)
            unpadded = re_ranking(qg[:nq, :n], qq_v, gg_v)
            if name == "padded":
                plain = re_ranking_padded(qg, qq, gg, nq, n, min_sum_fn=ops.minplus_plain)[:nq, :n]
            else:
                plain = re_ranking(qg, qq, gg, valid=(nq, n), min_sum_fn=ops.minplus_plain)[:nq, :n]
            refs[name] = unpadded.cpu().numpy(), plain.cpu().numpy(), noisy.cpu().numpy()
    errs = {name: {"vs_unpadded": topk_agreement(*rr, refs[name][0]),
                   "vs_plain_min_sum": topk_agreement(*rr, refs[name][1]),
                   "vs_unpadded_noisy_diagonal": topk_agreement(*rr, refs[name][2])}
            for name, rr in (("padded", rr_padded), ("staged", rr_staged))}
    staged_vs_padded = {"matches_equal": bool(np.array_equal(rr_staged[0], rr_padded[0])),
                        "max_abs_diff": float(np.abs(rr_staged[1] - rr_padded[1]).max())}
    log("serve", export_s=export_s, artifact_bytes=model.stat().st_size, artifact=artifact, graph=graph, export_batch=b,
        frames=geo["seq_len"],
        frame=list(geo["frame"]), describe_clips=len(clips), describe_s=describe_s,
        describe_clips_per_s=len(clips) / describe_s, describe_max_abs_diff=desc_err,
        concurrent_describe_max_abs_diff=conc_err, describe_batching=stats["describe_batching"],
        padded=padded, staged=staged, rerank_errors=errs, staged_vs_padded=staged_vs_padded,
        rerank_shape=[b, b + geo["capacity"] + 256], staged_n=b + geo["staged_capacity"] + 256,
        ops=stats["ops"])
    check(desc_err <= 1e-4 and conc_err <= 1e-4, f"daemon describe vs the modules: {desc_err}, {conc_err}")
    check(stats["describe_batching"]["packed"] > 0, f"no packed dispatch: {stats['describe_batching']}")
    check(staged_vs_padded["max_abs_diff"] <= KERNEL_TOL, f"staged vs padded route: {staged_vs_padded}")
    for name, e in errs.items():
        for what in ("vs_unpadded", "vs_plain_min_sum"):
            check(e[what]["max_abs_diff"] <= KERNEL_TOL, f"{name} route {what}: {e[what]}")
    if cuda:
        slabs = -(-(b + geo["staged_capacity"] + 256) // rerank_mod._MINPLUS_CHUNK)
        check(padded["launches"] == 1, f"padded route launched the kernel {padded['launches']} times")
        check(staged["launches"] == slabs, f"staged route launched {staged['launches']}, expected {slabs}")
        check(padded["warm_up_nearest_launches"] >= 1, "the daemon's warm-up did not launch the nearest kernel")
        check((padded["nearest_launches"], staged["nearest_launches"]) == (1, 0),
              f"nearest launches: padded {padded['nearest_launches']}, staged {staged['nearest_launches']}")
    return ({"serve_padded": padded["launches"], "serve_staged": staged["launches"],
             "serve_devices": devices["launches"]},
            {"serve_warm_up": padded["warm_up_nearest_launches"], "serve_padded": padded["nearest_launches"],
             "serve_staged": staged["nearest_launches"]})


class Tee(io.TextIOBase):
    """Writes to ``stream`` and keeps a copy (a daemon's stderr, read back)."""

    def __init__(self, stream):
        self.stream, self.copy = stream, io.StringIO()

    def write(self, text):
        self.copy.write(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def serve_devices(common, geo, queries, k, device, sock, rr_staged):
    """``serve_devices``: ``serve --devices 2`` on the staged daemon's
    artifact, index and capacity. On a one-card machine it runs one rank on
    the staged route and says so on stderr; its re-ranked answers are the
    staged daemon's. Launch counts zeroed just before its re-ranked request
    and read just after."""
    cuda = torch.device(device).type == "cuda"
    info = {}
    tee = Tee(sys.stderr)
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(tee), daemon(["--gallery", str(SERVE_DIR / "index.npz"), "--capacity",
                                                  str(geo["staged_capacity"]), *common, "--devices", "2"],
                                                 device, sock) as c:
        info["ready_s"] = time.perf_counter() - t0
        ping = c.ping()
        zero_launches()
        sync(device)
        rr = c.rank(features=queries, topk=k, rerank=True)
        sync(device)
        info["launches"], info["nearest_launches"] = read_launches()["minplus"], read_launches()["nearest"]
        info["rerank_ms"] = median_ms(lambda: c.rank(features=queries, topk=k, rerank=True), reps=3)
    said = [ln for ln in tee.copy.getvalue().splitlines() if ln.startswith("--devices 2:")]
    idx, scores = answer(rr)
    visible = parallel.visible_devices(device)
    info.update(rerank_devices=ping["rerank_devices"], rerank_staged=ping["rerank_staged"], said=said,
                visible_devices=visible, matches_equal_staged=bool(np.array_equal(idx, rr_staged[0])),
                vs_staged_max_abs_diff=float(np.abs(scores - rr_staged[1]).max()))
    log("serve_devices", **info, tol=KERNEL_TOL)
    check(rr["reranked"] and ping["rerank_staged"], f"serve --devices 2: {ping}")
    check(info["matches_equal_staged"] and info["vs_staged_max_abs_diff"] <= KERNEL_TOL,
          f"serve --devices 2 vs the staged route: {info['vs_staged_max_abs_diff']}")
    if cuda and visible == 1:
        check(ping["rerank_devices"] == 1 and said, f"serve --devices 2 on one card: {ping}, said {said}")
        slabs = -(-(geo["batch"] + geo["staged_capacity"] + 256) // rerank_mod._MINPLUS_CHUNK)
        check(info["launches"] == slabs, f"serve --devices 2 launched {info['launches']}, expected {slabs}")
    return info


def phase_cli_bf16(gen, device="cuda", extra=(), geo=SERVE):
    """``cli.train --bf16 --rerank 1`` for one epoch, ``cli.evaluate --bf16
    --rerank 1`` on its checkpoint (launch counts zeroed before each and
    read after; each re-ranking held against the plain min-sum), then
    ``export-model --bf16`` at full width and one ``describe`` through a
    daemon against the in-process bf16 descriptor."""
    cuda = torch.device(device).type == "cuda"
    logs = BUILD / "chip_cli_bf16"
    shutil.rmtree(logs, ignore_errors=True)
    train_argv = [*CLI_TRAIN[:-1], str(logs), "--bf16", "--epochs", "1", *extra]
    out, launches, errs = {}, {}, {}
    for what, module, argv in (
            ("train", cli_train, train_argv),
            ("evaluate", cli_evaluate, ["-d", "synthetic", "--synthetic-ids", str(SYNTH_IDS), "--seed", "0",
                                        "--rerank", "1", "--bf16", "--logs-dir", str(logs),
                                        "--checkpoint", str(logs / "checkpoint.npz"), *extra])):
        zero_launches()
        sync(device)
        with recording() as rec:
            t0 = time.perf_counter()
            top1 = run_cli(module, argv, device)
            sync(device)
            out[f"{what}_seconds"] = time.perf_counter() - t0
        launches[what] = read_launches()["minplus"]
        res = rec["evals"][-1]
        errs[what] = rerank_vs_plain(res)
        out[f"{what}_top1"] = top1
        check(res.qf.dtype == torch.float32 and bool(torch.isfinite(res.distmat).all()),
              f"cli.{what} --bf16: descriptors {res.qf.dtype}, distmat finite")
        if what == "train":
            check(rec["state"].step >= 1 and np.isfinite(rec["epochs"][-1]["loss"]), "cli.train --bf16 did not train")
            out["epoch_stats"] = rec["epochs"]
    ckpt = logs / "checkpoint.npz"

    # the bf16 artifact at full width, and a daemon's describe of it
    model = logs / "model_bf16.npz"
    (h, w), b = geo["frame"], geo["batch"]
    t0 = time.perf_counter()
    meta = extract_main(["export-model", "--checkpoint", str(ckpt), "--num-classes", str(SYNTH_IDS), "--bf16",
                         "--batch", str(b), "--seq_len", str(geo["seq_len"]), "--height", str(h), "--width",
                         str(w), "-o", str(model), *extra], device)
    out["export_seconds"] = time.perf_counter() - t0
    args = cli_train.build_parser().parse_args([*train_argv])
    cnn, sia, unc = cli_train.build_models(args, tiny=args.tiny)
    state = init_train_state(cnn, sia, unc, SYNTH_IDS, num_feat=cnn.num_feat, device=device)
    load_train_state(state, str(ckpt))
    rng = np.random.RandomState(1)
    clips = rng.randint(0, 256, (b, geo["seq_len"], h, w, 3), np.uint8)
    np.savez(logs / "clips.npz", clips=clips)
    with torch.inference_mode():
        want = make_descriptor_fn(cnn.eval(), sia.eval())(torch.from_numpy(clips).to(device)).cpu().numpy()
    del state, cnn, sia, unc
    out["artifact"] = artifact_check(model, clips, device)
    sock = str(logs / "d.sock")
    if len(sock) > 100:  # AF_UNIX paths are short
        sock = os.path.relpath(sock)
    with loaded_artifacts() as loaded, daemon(["--model", str(model)], device, sock) as c:
        mark = dispatch_mark(c, loaded)
        t0 = time.perf_counter()
        got = c.describe(str(logs / "clips.npz"))["features"]
        out["describe_seconds"] = time.perf_counter() - t0
        out["graph"] = graph_dispatches(mark, dispatch_mark(c, loaded), loaded, device, "cli_bf16 daemon")
    desc_err = float(np.abs(got - want).max())
    log("cli_bf16", launches=launches, rerank_vs_plain_max_abs_diff=errs, artifact_bytes=model.stat().st_size,
        export_dim=meta["dim"], describe_vs_modules_max_abs=desc_err, checkpoint_bytes=ckpt.stat().st_size, **out)
    if cuda:
        for what, n in launches.items():
            check(n > 0, f"cli.{what} --bf16 --rerank 1 did not launch the min-plus kernel")
    for what, err in errs.items():
        check(err <= KERNEL_TOL, f"cli.{what} --bf16 re-ranking, kernel vs plain min-sum: {err}")
    check(got.dtype == np.float32 and desc_err <= 1e-4, f"bf16 daemon describe vs the modules: {desc_err}")
    check(c.bye["ok"], "bf16 daemon shutdown")
    return launches


def phase_extract_cli(device="cuda", extra=()):
    """``cli.extract features`` for query and gallery on ``cli_train``'s
    checkpoint, then ``rank --rerank``, in this process; the ranking is
    held against the same re-ranking with the plain min-sum."""
    common = ["-d", "synthetic", "--synthetic-ids", str(SYNTH_IDS), "--logs-dir", str(CLI_DIR),
              "--checkpoint", str(CLI_DIR / "checkpoint.npz"), *extra]
    t0 = time.perf_counter()
    path = {split: str(SERVE_DIR / f"features_{split}.npz") for split in ("query", "gallery")}
    for split in path:
        extract_main(["features", *common, "--split", split, "-o", path[split]], device)
    features_s = time.perf_counter() - t0
    zero_launches()
    sync(device)
    t0 = time.perf_counter()
    results = extract_main(["rank", "--query", path["query"], "--gallery", path["gallery"], "--topk", "10",
                            "--rerank", "-o", str(SERVE_DIR / "ranks.json")], device)
    sync(device)
    rank_s = time.perf_counter() - t0
    launches = read_launches()
    qf, gf = (torch.from_numpy(np.load(path[s])["features"]).to(device) for s in ("query", "gallery"))
    with torch.inference_mode():
        plain = re_ranking(cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf),
                           min_sum_fn=ops.minplus_plain).cpu().numpy()
    idx, scores = answer({"results": results})
    agree = topk_agreement(idx, scores, plain)
    log("extract_cli", queries=int(qf.shape[0]), gallery=int(gf.shape[0]), features_s=features_s, rank_s=rank_s,
        launches=launches, vs_plain_min_sum=agree)
    if torch.device(device).type == "cuda":
        check(launches["minplus"] == 1, f"rank --rerank launched the kernel {launches['minplus']} times")
    check(len(results) == qf.shape[0] and np.isfinite(scores).all(), "rank --rerank results")
    check(agree["max_abs_diff"] <= KERNEL_TOL, f"rank --rerank vs plain min-sum: {agree}")
    return launches


def artifact_with_example(model, device):
    """``model``'s program saved as ``export-model`` saved it before the
    example input was cleared: the same program with its zero example
    batch (the meta's shape) kept. Returns ``(path, bytes of the new
    program, bytes of the old one, bytes of the example)``."""
    with np.load(model, allow_pickle=False) as z:
        blob, meta_json = z["exported"].tobytes(), str(z["meta"])
    meta = json.loads(meta_json)
    shape = (meta["batch"], meta["seq_len"], meta["height"], meta["width"], meta["channels"])
    program = torch.export.load(io.BytesIO(blob))
    program.example_inputs = ((torch.zeros(shape, dtype=torch.uint8, device=device),), {})
    buf = io.BytesIO()
    torch.export.save(program, buf)
    old = Path(model).with_name(Path(model).stem + "_with_example.npz")
    np.savez(old, exported=np.frombuffer(buf.getvalue(), np.uint8), meta=meta_json)
    return old, len(blob), len(buf.getvalue()), int(np.prod(shape))


GRAPH_TOL = 1e-5  # the replayed graph against the eager program: the same kernels, expected bit-equal


@contextlib.contextmanager
def loaded_artifacts():
    """Each ``cli_extract._load_artifact`` made inside (a daemon's among
    them): ``[{"call": call, "seconds": load seconds}]``."""
    loaded, load = [], cli_extract._load_artifact

    def record(path, device):
        t0 = time.perf_counter()
        call, meta = load(path, device)
        loaded.append({"call": call, "seconds": time.perf_counter() - t0})
        return call, meta

    cli_extract._load_artifact = record
    try:
        yield loaded
    finally:
        cli_extract._load_artifact = load


def dispatch_mark(c, loaded):
    """A daemon's coalescer dispatches (its stats op) and its artifact
    call's graph replays, now."""
    return c.stats()["describe_batching"]["dispatches"], getattr(loaded[-1]["call"], "replays", None)


def graph_dispatches(before, after, loaded, device, what):
    """Over a daemon's requests between two ``dispatch_mark``s: on the card
    one graph replay per coalescer dispatch; with the call's load seconds
    and graph pool bytes."""
    call = loaded[-1]["call"]
    out = {"dispatches": after[0] - before[0],
           "replays": None if after[1] is None else after[1] - before[1],
           "load_s": loaded[-1]["seconds"], "pool_bytes": getattr(call, "pool_bytes", None)}
    if torch.device(device).type == "cuda":
        check(isinstance(call, cli_extract._GraphCall), f"{what}: the daemon's call is {type(call).__name__}")
        check(out["dispatches"] > 0 and out["replays"] == out["dispatches"],
              f"{what}: {out['replays']} graph replays for {out['dispatches']} dispatches")
    return out


def program_ops(program, top=8):
    """The loaded program's ``call_function`` nodes: their number and the
    most frequent targets."""
    targets = [getattr(n.target, "__name__", str(n.target)) for n in program.graph.nodes if n.op == "call_function"]
    counts = {}
    for t in targets:
        counts[t] = counts.get(t, 0) + 1
    return {"call_function": len(targets), "top": sorted(counts.items(), key=lambda kv: -kv[1])[:top]}


def artifact_check(model, clips, device):
    """The artifact without its example input against the same program with
    it: bytes of each and the answers of both (``_load_artifact``'s call on
    one batch of ``clips``), which must be bit-equal. Then the call (on the
    card one CUDA graph replayed) on a second, different batch (``255 -
    clips``) right after the first: both answers held to the eager
    ``torch.export.load(...).module()`` within ``GRAPH_TOL`` (expected
    bit-equal), the first answer unchanged by the second call, ``replays``
    counting both; the load seconds, the graph pool's bytes and the
    program's op nodes beside."""
    cuda = torch.device(device).type == "cuda"
    old, new_bytes, old_bytes, example_bytes = artifact_with_example(model, device)
    answers, load_s = [], []
    for path in (old, model):
        t0 = time.perf_counter()
        call = cli_extract._load_artifact(str(path), device)[0]
        load_s.append(time.perf_counter() - t0)
        answers.append(call(clips))
    out = {"program_bytes": new_bytes, "with_example_program_bytes": old_bytes, "example_bytes": example_bytes,
           "bytes_dropped": old_bytes - new_bytes, "file_bytes": Path(model).stat().st_size,
           "with_example_file_bytes": old.stat().st_size,
           "answers_bit_equal": answers[0].dtype == answers[1].dtype and answers[0].tobytes() == answers[1].tobytes()}
    old.unlink()
    first, second = answers[1], np.uint8(255) - clips
    kept = first.copy()
    got = [first, call(second)]
    with np.load(model, allow_pickle=False) as z:
        eager = torch.export.load(io.BytesIO(z["exported"].tobytes())).module()
    with torch.inference_mode():
        want = [eager(torch.from_numpy(x).to(device)).to(torch.float32).cpu().numpy() for x in (clips, second)]
    out["graph"] = {"call": type(call).__name__, "load_s": load_s, "replays": getattr(call, "replays", None),
                    "pool_bytes": getattr(call, "pool_bytes", None),
                    "vs_eager_max_abs": max(float(np.abs(g - w).max()) for g, w in zip(got, want)),
                    "vs_eager_bit_equal": all(g.tobytes() == w.tobytes() for g, w in zip(got, want)),
                    "first_unchanged": first.tobytes() == kept.tobytes(),
                    "batches_differ": not np.array_equal(got[0], got[1]), "tol": GRAPH_TOL,
                    "program_ops": program_ops(eager)}
    del call, eager
    empty_cache(device)
    check(out["answers_bit_equal"], f"artifact without the example input answers otherwise: {out}")
    check(out["bytes_dropped"] >= example_bytes, f"artifact did not drop its example input: {out}")
    g = out["graph"]
    check(g["vs_eager_max_abs"] <= GRAPH_TOL and g["first_unchanged"] and g["batches_differ"],
          f"the artifact's call against the eager program: {g}")
    if cuda:
        check(g["call"] == "_GraphCall" and g["replays"] == 2 and g["pool_bytes"] > 0,
              f"the artifact's call on the card is not one graph replay per batch: {g}")
    return out


def phase_entry(device="cuda"):
    """``grl_tpu_torch.entry.entry``: the full-size eval-mode forward on its
    zero clip pair, output shapes, finite values, warm ms."""
    module, (clips,) = hooks.entry(device)
    with torch.inference_mode():
        out = module(clips)
        ms = cuda_ms(lambda: module(clips), 5) if torch.device(device).type == "cuda" else None
    shapes = [list(o.shape) for o in out]
    finite = all(bool(torch.isfinite(o).all()) for o in out)
    log("entry", example=list(clips.shape), example_dtype=str(clips.dtype), device=str(clips.device),
        out_shapes=shapes, finite=finite, warm_ms=ms)
    check(shapes == [[2, 2048], [2, 8, 2048]], f"entry forward shapes {shapes}")
    check(finite and clips.device.type == torch.device(device).type, "entry forward not finite or off the device")
    del module, clips, out
    empty_cache(device)


def phase_dryrun(device="cuda", counts=DRYRUN_RANKS):
    """``grl_tpu_torch.entry.dryrun_multichip(n)`` for each ``n``: every rank
    finite, its min-plus launches (each rank counts its own from zero), and
    its re-ranking held against the one-process builder with the plain
    min-sum on the same inputs."""
    cuda = torch.device(device).type == "cuda"
    launches = {}
    for n in counts:
        zero_launches()
        t0 = time.perf_counter()
        ranks = hooks.dryrun_multichip(n, device, timeout=600)
        seconds = time.perf_counter() - t0
        _, _, feats, _ = hooks.dryrun_data(n)
        f = torch.from_numpy(feats).to(device)
        d = -(f @ f.T)
        plain = re_ranking(d[:n, n:], d[:n, :n], d[n:, n:], k1=hooks.RERANK_K[0], k2=hooks.RERANK_K[1],
                           min_sum_fn=ops.minplus_plain).cpu().numpy()
        rows = [{"rank": r["rank"], "device": r["device"], "backend": r["backend"], "loss": r["loss"],
                 "mAP": r["mAP"], "launches": r["launches"]["minplus"],
                 "rerank_vs_plain_max_abs_diff": float(np.abs(r["rerank"] - plain).max())} for r in ranks]
        launches[f"dryrun_{n}"] = [r["launches"] for r in rows]
        log("dryrun", ranks=n, seconds=seconds, per_rank=rows)
        check(len(rows) == n and all(np.isfinite(r["loss"]) and np.isfinite(r["mAP"]) for r in rows),
              f"dryrun_multichip({n}) results {rows}")
        for r in rows:
            check(r["rerank_vs_plain_max_abs_diff"] <= KERNEL_TOL, f"dryrun_multichip({n}) rank {r['rank']} "
                  f"re-ranking, kernel vs plain min-sum: {r['rerank_vs_plain_max_abs_diff']}")
            if cuda:
                check(r["launches"] > 0, f"dryrun_multichip({n}) rank {r['rank']} did not launch the min-plus kernel")
    return launches


def phase_learning_equivalence(device="cuda", extra=(), frame=FRAME, argv=LEQ_ARGS, first_loss=LEQ_FIRST_LOSS):
    """One seed of ``tools/learning_equivalence.py`` at the recorded runs'
    schedule (the port's ``cli.train -d mars`` in a subprocess, on a fake-MARS
    tree): the first-step loss within ``first_loss``, evaluations at the
    recorded epochs, a finite final mAP; the final mAP and rank-1 beside the
    recorded medians (one seed is not a verdict: no gate on them)."""
    shutil.rmtree(LEQ_DIR, ignore_errors=True)
    args = leq.build_parser().parse_args(["--out", str(LEQ_DIR), "--device", device, *argv])
    t0 = time.perf_counter()
    tree = leq.build_tree(args, frame=frame)
    tree_s = time.perf_counter() - t0
    run = leq.run_torch(args, tree, args.seeds[0], extra=extra)
    summary = leq.summarize(args)
    recorded = {side: {k: summary[side][k]["median"] for k in ("final_mAP", "final_rank1", "first_step_loss")}
                | {"steps": len(json.loads((Path(args.recorded) / f"{side}_seed0.json").read_text())["loss_steps"])}
                for side in ("ref", "grl")}
    first = run["loss_steps"][0][1] if run["loss_steps"] else float("nan")
    final = run["evals"][-1] if run["evals"] else {}
    log("learning_equivalence", seed=run["seed"], seconds_per_seed=run["wall_s"], tree_seconds=tree_s,
        steps=len(run["loss_steps"]), first_step_loss=first, first_step_loss_band=first_loss,
        epoch_losses=run["epoch_losses"], evals=run["evals"], final_mAP=final.get("mAP"),
        final_rank1=final.get("rank1"), recorded_medians=recorded)
    if first_loss is not None:
        check(first_loss[0] <= first <= first_loss[1], f"first-step loss {first} outside {first_loss}")
    check([e["epoch"] for e in run["evals"]] == leq.eval_epochs(args.epochs),
          f"evaluations at epochs {[e['epoch'] for e in run['evals']]}, expected {leq.eval_epochs(args.epochs)}")
    check(np.isfinite(final.get("mAP", float("nan"))) and np.isfinite(final.get("rank1", float("nan"))),
          f"final evaluation {final}")
    check(all(np.isfinite(v) for _, v in run["loss_steps"]), "non-finite training loss")
    return run


BENCH_SWEEP = (32, 64, 96, 128, 192)  # micro-batches of the bench's descriptor rate (its key stays at 96)


def bench_py_keys():
    """The keys of the dict that the root ``bench.py`` prints."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    dumps = [n for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
             and n.func.attr == "dumps" and n.args and isinstance(n.args[0], ast.Dict)]
    return [key.value for key in dumps[0].args[0].keys]


def phase_bench(device="cuda", sweep=BENCH_SWEEP):
    """``python -m grl_tpu_torch.bench`` in a subprocess, as a user runs it:
    one JSON line whose keys are bench.py's, both rates finite and above 0;
    then, in this process, the descriptor's rate at each micro-batch of
    ``sweep`` (``bench.descriptor_clips_per_sec`` on one set of bench's
    models) with its peak memory."""
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "grl_tpu_torch.bench", *([] if cuda else ["--device", device])],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - t0
    check(run.returncode == 0, f"grl_tpu_torch.bench exited {run.returncode}: {run.stderr[-3000:]}")
    lines = run.stdout.strip().splitlines()
    line = json.loads(lines[-1])
    log("bench", line=line, seconds=seconds)
    check(len(lines) == 1 and list(line) == bench_py_keys(), f"bench printed {lines}")
    for key in ("value", "gallery_queries_per_sec"):
        check(np.isfinite(line[key]) and line[key] > 0, f"bench {key} = {line[key]}")
    modules = bench.build_models(device)
    rates = {}
    for batch in sweep:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        rate = bench.descriptor_clips_per_sec(batch, device, modules)
        rates[batch] = {"clips_per_s": rate, "ms": 1e3 * batch / rate,
                        "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
    log("bench_sweep", dtype="bfloat16", seq_len=bench.SEQ_LEN, frame=[bench.H, bench.W], rates=rates)
    check(all(np.isfinite(r["clips_per_s"]) and r["clips_per_s"] > 0 for r in rates.values()), f"sweep {rates}")
    del modules
    empty_cache(device)
    return line, rates


DESCRIBE_TOL = 1e-5  # fp32 descriptor rows of a padded chunk against the same clips unpadded
PROBE_REPEATS = {"bandwidth_reps": 3, "int8_iters": 3, "iters": 3, "steps": 3, "windows": 1, "warm": 1}
# the sweeps' variants here: each of their paths once (in this process, a
# child that autotunes, the graph, the deterministic child); the CLIs run
# them all. The step's autotuning child (~35 s, the search ~21 s of it) is
# left to the CLI: its path is the descriptor's and the deterministic row's
PROBE_SWEEP = ("default", "cudnn_benchmark", "channels_last", "cuda_graph")
PROBE_TRAIN_SWEEP = ("default", "channels_last", "fp32", "fp32_deterministic")


def phase_probes(cnn, sia, device="cuda"):
    """``describe_clips`` through the rrs_test row path at full width, then
    the probe and sweep tools' functions at ``PROBE_REPEATS`` (their sizes
    as the CLIs run them)."""
    rrs_batch, micro_batch, reps = 43, 32, PROBE_REPEATS  # loader batches of 43: chunks of 32 and 11
    t_phase = time.perf_counter()
    zero_launches()
    ds = SyntheticVideoReID(num_train_ids=0, num_test_ids=24, tracklets_per_id=2, num_cams=2,
                            frames_range=(8, 40), height=FRAME[0], width=FRAME[1], seed=1)
    evaluator = Evaluator(cnn, sia, micro_batch=micro_batch, device=device)
    calls = []
    describe_clips = evaluator.describe_clips

    def spy(clips):
        out = describe_clips(clips)
        calls.append((np.array(clips), out))
        return out

    evaluator.describe_clips = spy
    loader = ClipLoader(ClipDataset(ds.gallery, 8, "rrs_test", *FRAME), batch_size=rrs_batch, workers=4)
    t0 = time.perf_counter()
    feats, pids, _ = evaluator.extract_features(loader)
    sync(device)
    rrs_s = time.perf_counter() - t0
    buckets = [(int(d.shape[0]), size) for _, out in calls for d, size in out]
    errs = []
    with torch.inference_mode():
        for clips, out in calls:
            for i, (d, size) in enumerate(out):
                plain = evaluator._describe(evaluator._to_device(clips[i * micro_batch: i * micro_batch + size]))
                errs.append(float((d[:size] - plain).abs().max()))
    rows_ok = torch.equal(feats, torch.cat([d[:size] for _, out in calls for d, size in out]))
    log("describe_clips", items=len(ds.gallery), loader_batch=rrs_batch, micro_batch=micro_batch, buckets=buckets,
        rrs_seconds=rrs_s, max_abs_diff_vs_unpadded=max(errs), tol=DESCRIBE_TOL)
    check(len(pids) == feats.shape[0] == len(ds.gallery) and rows_ok, "rrs rows are not describe_clips' valid rows")
    check({b for b, _ in buckets} <= {micro_batch, micro_batch // 2, micro_batch // 3}, f"buckets {buckets}")
    check(max(errs) <= DESCRIBE_TOL, f"describe_clips vs the unpadded descriptor: {max(errs)}")
    del evaluator, feats, calls
    empty_cache(device)

    t0 = time.perf_counter()
    bw = probe_bandwidth.probe(device, reps["bandwidth_reps"])
    log("probe_bandwidth", card=nvidia_smi() if torch.device(device).type == "cuda" else None, **bw,
        seconds=time.perf_counter() - t0)
    check(all(np.isfinite(c["GB_per_s"]) and c["GB_per_s"] > 0 for c in bw["copies"].values())
          and bw["per_dispatch_ms"] > 0 and bw["item_ms"] > 0, f"probe_bandwidth {bw}")

    t0 = time.perf_counter()
    i8 = probe_int8.probe(device, iters=reps["int8_iters"])
    log("probe_int8", **i8, seconds=time.perf_counter() - t0)
    int8 = ("matmul_int8", "matmul_int8_b_colmajor", "im2col_int8", "im2col_int8_w_colmajor")
    for key in int8:
        check(i8[key].get("exact") is True, f"probe_int8 {key}: {i8[key]}")
    for key in (*int8, "matmul_bf16", "conv_bf16"):
        check(np.isfinite(i8[key]["tops"]) and i8[key]["tops"] > 0, f"probe_int8 {key}: {i8[key]}")
    empty_cache(device)

    t0 = time.perf_counter()
    sweep = sweep_compiler_options.sweep(device, iters=reps["iters"], windows=reps["windows"], warm=reps["warm"],
                                         variants=PROBE_SWEEP, report=lambda line: None)
    log("sweep_compiler_options", dtype="bfloat16", variants=sweep, seconds=time.perf_counter() - t0)
    empty_cache(device)

    t0 = time.perf_counter()
    train_sweep = sweep_train_compiler_options.sweep(device, steps=reps["steps"], windows=reps["windows"],
                                                     warm=reps["warm"], variants=PROBE_TRAIN_SWEEP,
                                                     report=lambda line: None)
    log("sweep_train_compiler_options", variants=train_sweep, seconds=time.perf_counter() - t0)
    for name, row in train_sweep.items():
        check(all(np.isfinite(t) and t > 0 for t in row["ms_per_step"]) and np.isfinite(row["loss"]),
              f"sweep_train_compiler_options {name}: {row}")
    empty_cache(device)
    launches = read_launches()
    log("probes", seconds=time.perf_counter() - t_phase, launches=launches, policy_after=precision_flags(),
        cudnn_benchmark_after=torch.backends.cudnn.benchmark)
    check_fp32_policy("the probes phase", precision_flags())
    check(not torch.backends.cudnn.benchmark, "a sweep left cudnn.benchmark on")
    return launches


def host_inventory():
    """What the machine offers the data plane and the scalar writer."""
    def version(name):
        if importlib.util.find_spec(name) is None:
            return None
        return getattr(__import__(name), "__version__", "present")

    return {"PIL": version("PIL"), "scipy": version("scipy"), "tensorboardX": version("tensorboardX"),
            "g++": shutil.which("g++"), "native_jpeg": jpeg.native_available(),
            "native_jpeg_error": jpeg.NATIVE_INFO["error"]}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs only on a card",
              file=sys.stderr)
        return 1
    set_precision()  # the CLIs' policy, for the phases that call the library directly
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)
    log("host", **host_inventory())
    t_start = time.perf_counter()

    for name, build in (("minplus", build_minplus), ("nearest", build_nearest)):
        t0 = time.perf_counter()
        build()
        info = BUILD_INFO[name]
        log("build", kernel=name, seconds=time.perf_counter() - t0, nvcc_seconds=info["seconds"],
            ptxas=[ln.strip() for ln in info["log"].splitlines() if "registers" in ln or "spill" in ln
                   or "smem" in ln])

    gen = torch.Generator(device="cuda").manual_seed(0)
    entry = phase_kernels(gen)
    nearest_entry = phase_nearest(gen)
    cnn, sia = phase_model(gen)
    launches = phase_slice(cnn, sia)
    phase_probes(cnn, sia)
    del cnn, sia
    torch.cuda.empty_cache()
    phase_entry()
    rates = phase_model_bf16(gen)
    phase_bench()
    phase_mars(gen)
    phase_train_check(gen)
    state, ds = phase_train(gen)
    train_launches = phase_train_eval(state, ds)
    del state
    torch.cuda.empty_cache()
    dp_launches = phase_data_parallel()
    torch.cuda.empty_cache()
    state, ds = phase_train(gen, bf16=True)
    step_ms, vs_fp64 = phase_precision_steps(state, ds, gen)
    del state
    torch.cuda.empty_cache()
    log("tf32", descriptor_ms_per_32_clips={"off": rates["fp32_mb32"]["ms"], "on": rates["fp32_tf32_mb32"]["ms"],
                                            "off_again": rates["fp32_again_mb32"]["ms"]},
        step_ms_batch16={"off": step_ms["fp32"]["ms"], "on": step_ms["fp32_tf32"]["ms"],
                         "off_again": step_ms["fp32_again"]["ms"]},
        step_all_l2_from_fp64={k: v["all_l2"] for k, v in vs_fp64.items()}, policy_after=precision_flags())
    check_fp32_policy("chip_smoke after the tf32 phase", precision_flags())
    final, cli_train_launches = phase_cli_train()
    phase_cli_resume(final)
    del final
    torch.cuda.empty_cache()
    cli_eval_launches = phase_cli_evaluate()
    mars_launches = phase_cli_mars()
    torch.cuda.empty_cache()
    trees = phase_fake_trees()
    phase_prepare_real_data(trees)
    duke_launches = phase_cli_duke(trees["duke"])
    torch.cuda.empty_cache()
    phase_profile()
    torch.cuda.empty_cache()
    flow_launches, flow_ckpt = phase_flow_cli()
    torch.cuda.empty_cache()
    flow_rank_launches = phase_flow_serve(flow_ckpt, gen)
    torch.cuda.empty_cache()
    phase_flow_models(gen)
    torch.cuda.empty_cache()
    staged_launches, staged_info, staged = phase_rerank_staged()
    torch.cuda.empty_cache()
    sharded_launches = phase_sharded(staged, staged_info)
    del staged
    torch.cuda.empty_cache()
    dryrun_launches = phase_dryrun()
    serve_launches, serve_nearest = phase_serve(gen)
    torch.cuda.empty_cache()
    rank_cli_launches = phase_extract_cli()
    torch.cuda.empty_cache()
    bf16_launches = phase_cli_bf16(gen)
    torch.cuda.empty_cache()
    phase_learning_equivalence()

    # launches on this slice's path (the sharded evaluation, summed over its
    # two ranks); every other path's count beside it
    entry["launches"] = sum(sharded_launches["eval_sharded"])
    entry["launches_by_path"] = {"evaluate": launches["minplus"], "train": train_launches["minplus"],
                                 "cli_train": cli_train_launches["minplus"],
                                 "cli_evaluate": cli_eval_launches["minplus"],
                                 "cli_mars_evaluate": mars_launches["minplus"],
                                 "cli_duke_evaluate": duke_launches["minplus"],
                                 "rerank_staged": staged_launches, **serve_launches,
                                 "rank_cli": rank_cli_launches["minplus"],
                                 "cli_bf16_train": bf16_launches["train"],
                                 "cli_bf16_evaluate": bf16_launches["evaluate"],
                                 "flow_train": flow_launches["train"], "flow_evaluate": flow_launches["evaluate"],
                                 "flow_rank_cli": flow_rank_launches, "dp_evaluate": dp_launches,
                                 **{path: sum(n) for path, n in sharded_launches.items()},
                                 **{path: sum(n) for path, n in dryrun_launches.items()}}
    entry["launches_by_rank"] = sharded_launches | dryrun_launches
    entry["max_err"], entry["kernel_ms"] = entry["max_abs_err"], entry["ms"]
    # the one-program and padded routes select with it; the staged and sharded ones do not
    nearest_entry["launches_by_path"] = {"evaluate": launches["nearest"], "train": train_launches["nearest"],
                                         "cli_train": cli_train_launches["nearest"],
                                         "cli_evaluate": cli_eval_launches["nearest"],
                                         "cli_mars_evaluate": mars_launches["nearest"],
                                         "cli_duke_evaluate": duke_launches["nearest"],
                                         "rank_cli": rank_cli_launches["nearest"], **serve_nearest}
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [entry, nearest_entry]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
