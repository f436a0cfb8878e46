"""Indexing a gallery: dense descriptors of tracklets, closed loop.

The window calls ``Evaluator.extract_features`` over one dense
``ClipLoader`` after another, each over ``chunk_tracklets`` tracklets of
the frame pool (and a few fillers that make every call's clips a whole
number of micro-batches, so every dispatch has the warmed shape), as fast
as they complete, and reads each call's features back to the host. The
lengths are one seeded multiset for every run (log-normal, mean
``length_mean``), in an order, at pool offsets and with ids and cameras
drawn from the run's seed.

``describe_clips_per_s``: the window's clips over its seconds. The check
takes ``sample`` of the window's tracklets, drawn from the seed, and the
longest, describes them again with the plain reference in fp32 (TF32 off)
and compares: ``feature_gap`` is the largest ``|f - f_ref| / |f_ref|``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import counts, weights
from ..reference import grl as ref
from ..reference.sampling import dense_indices
from . import frames

BLOCK = 16  # clips per reference call


class _TimedLoader:
    """A loader whose every ``next()`` is a ``loader.next`` span."""

    def __init__(self, loader, spans):
        self.dataset = loader.dataset
        self._loader = loader
        self._spans = spans

    def __iter__(self):
        it = iter(self._loader)
        while True:
            with self._spans("loader.next"):
                item = next(it, None)
            if item is None:
                return
            yield item


def clip_count(length, seq_len):
    return -(-length // seq_len)


def plan_lengths(p, seq_len):
    """The lengths of one call: the seeded multiset, then fillers up to a
    whole number of micro-batches of clips."""
    lengths = list(frames.lognormal_lengths(np.random.RandomState(p["sizes_seed"]), p["chunk_tracklets"],
                                            p["length_mean"], p["length_sigma"], p["length_min"],
                                            p["length_max"]))
    short = -sum(clip_count(n, seq_len) for n in lengths) % p["micro_batch"]
    per = p["length_max"] // seq_len
    while short:
        c = min(short, per)
        lengths.append(c * seq_len)
        short -= c
    return np.array(lengths)


def models(cfg, precision, device):
    from grl_tpu_torch.models import GRLModel, ResNetTrunk, Siamese

    cd = torch.bfloat16 if precision == "bf16" else None
    with torch.device(device):
        trunk = ResNetTrunk(tuple(cfg["trunk_layers"]), width=cfg["trunk_width"], compute_dtype=cd)
        cnn = GRLModel(trunk=trunk, compute_dtype=cd)
        siamese = Siamese(cfg["feat_dim"], cfg["siamese_out"], compute_dtype=cd)
    return cnn, siamese


def calibration_clips(pool, rng, n, seq_len, device):
    starts = rng.randint(0, pool.shape[0] - seq_len + 1, n)
    return torch.from_numpy(np.stack([pool[s : s + seq_len] for s in starts])).to(device)


@torch.no_grad()
def reference_features(w, pool, tracklets, cfg, precision):
    """The plain reference's mean dense descriptor of each ``(start, length)``."""
    net = ref.Net(w, mode="eval", precision=precision)
    grids = [dense_indices(int(length), cfg["seq_len"]) + start for start, length in tracklets]
    idx = np.concatenate(grids)
    device = w["cnn.corr_bn.weight"].device
    descs = torch.cat([ref.descriptor(net, torch.from_numpy(pool[idx[i : i + BLOCK]]).to(device),
                                      cfg["trunk_layers"]) for i in range(0, len(idx), BLOCK)])
    return torch.stack([d.mean(dim=0) for d in descs.split([len(g) for g in grids])])


def feature_gap(feats, ref_feats):
    return float(((feats - ref_feats).norm(dim=1) / ref_feats.norm(dim=1)).max())


def run(ctx, control=None):
    """One run (see the module docstring). ``control``: a precision for the
    reference put in the program's place; its gap comes back as
    ``outcome.control`` (``reid_bench.control``)."""
    from grl_tpu_torch import set_precision
    from grl_tpu_torch.data.loader import ClipDataset, ClipLoader
    from grl_tpu_torch.engine import Evaluator

    from ..run import Outcome
    from ..trace import DeviceTrace

    cfg, p, dev, spans = ctx.config, ctx.params, ctx.device, ctx.spans
    t, h, w = cfg["seq_len"], cfg["height"], cfg["width"]
    set_precision()
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cnn, siamese = models(cfg, ctx.workload["precision"], dev)
    pool = frames.frame_pool(ctx.subseed(1), p["pool_frames"], h, w, p["pool_segment"], p["noise"], dev)
    wts = weights.generate(weights.shapes_of(("cnn", cnn), ("siamese", siamese)), ctx.subseed(2), dev)
    ref.calibrate(wts, calibration_clips(pool, ctx.rng(3), p["calibration_clips"], t, dev), cfg["trunk_layers"])
    weights.load(wts, ("cnn", cnn), ("siamese", siamese))
    evaluator = Evaluator(cnn, siamese, micro_batch=p["micro_batch"], device=dev)

    lengths = plan_lengths(p, t)
    clips_per_call = int(sum(clip_count(n, t) for n in lengths))
    rng = ctx.rng(4)

    def call_plan():
        order = rng.permutation(len(lengths))
        ln = lengths[order]
        starts = rng.randint(0, pool.shape[0] - ln + 1)
        pids, cams = frames.ids_and_cams(rng, len(ln), cfg["num_test_ids"], cfg["num_cams"])
        return starts, ln, pids, cams

    def describe(plan):
        starts, ln, pids, cams = plan
        items = [(pool[s : s + n], int(pid), int(cam)) for s, n, pid, cam in zip(starts, ln, pids, cams)]
        loader = ClipLoader(ClipDataset(items, t, "dense", h, w), batch_size=1, workers=p["workers"])
        with spans("extract_features"):
            feats, _, _ = evaluator.extract_features(_TimedLoader(loader, spans))
        with spans("host_read"):
            float(feats[-1, -1])
        return feats

    # warm: the window's one descriptor shape, twice, through the same entry
    warm = ([0], [p["micro_batch"] * t], [0], [0])
    describe(warm)
    describe(warm)
    setup_s = time.time() - ctx.t0

    done = []  # (plan, features)
    seconds = min(ctx.seconds, p["trace_seconds"]) if ctx.trace else ctx.seconds
    tracer = DeviceTrace(dev) if ctx.trace else None
    if tracer:
        tracer.__enter__()
    first_span = len(spans.done)
    start = time.perf_counter()
    while True:
        plan = call_plan()
        done.append((plan, describe(plan)))
        window = time.perf_counter() - start
        if window >= seconds:
            break
    if tracer:
        tracer.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    clips = clips_per_call * len(done)
    attempted = len(lengths) * len(done)
    loader_wait = sum(e - s for n, s, e in spans.done[first_span:] if n == "loader.next") / 1e9

    # the check: a sample of the window's tracklets, the longest among them
    sample_rng = ctx.rng(5)
    picks = [(int(sample_rng.randint(len(done))), int(sample_rng.randint(len(lengths))))
             for _ in range(p["sample"])]
    c = int(sample_rng.randint(len(done)))
    picks.append((c, int(np.argmax(done[c][0][1]))))
    del evaluator, cnn, siamese
    feats = torch.stack([done[c][1][i] for c, i in picks]).float()
    tracklets = [(int(done[c][0][0][i]), int(done[c][0][1][i])) for c, i in picks]
    del done
    ref_feats = reference_features(wts, pool, tracklets, cfg, "fp32")
    out = Outcome(
        end_to_end={"describe_clips_per_s": clips / window}, setup_s=setup_s,
        attempted=attempted, failed=0,
        checks={"feature_gap": (feature_gap(feats, ref_feats), ctx.workload["limits"]["feature_gap"])},
        memory_peak_bytes=peak, window_s=window,
        counters={"clips": clips, "loader_wait_s": loader_wait},
        ops={"clip": counts.descriptor_ops(cfg)}, device_trace=tracer and tracer.timeline)
    if control is not None:
        out.control = {"feature_gap": feature_gap(reference_features(wts, pool, tracklets, cfg, control),
                                                  ref_feats)}
    return out
