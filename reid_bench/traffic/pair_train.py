"""Training: ``Trainer.train`` over (anchor, positive) pair batches,
closed loop.

The catalog is ``num_train_tracklets`` tracklets of ``num_train_ids`` ids
over ``num_cams`` cameras, windows of the frame pool (lengths one seeded
multiset, log-normal); ``RandomPairSampler`` and rrs_train sampling feed
one ``ClipLoader`` whose epoch runs through set-up and the window. The
state is built as ``cli.train`` builds it (``init_train_state``,
``make_train_step``, a ``Trainer``) at a constant learning rate.

Set-up drives the state through the window's own call and feed for three
steps and reads what the check needs on the way: each step's loss (the
trainer's scalar writer), the first gradients (the optimizer's momentum
after one step, less the weight decay) and the parameters' change after
the three. The window then calls ``Trainer.train`` for ``chunk_steps``
steps at a time; each call ends on a host read of its last step's loss.
``train_clips_per_s``: the window's clips over its seconds.

The check re-does the three steps with the plain reference in fp32 (TF32
off), from the same weights, on the same clips (the sampler, the frame
draws and the augmentation worked out again from the seed) and compares:
``loss_gap``, the largest ``|loss - loss_ref| / |loss_ref|`` of the three
steps; ``grad_gap`` and ``change_gap``, the largest over the parameters
of ``| |x| - |x_ref| | / max(|x_ref|, median |x_ref|)`` for the first
gradient and for the change. Parameters whose reference gradient is under
a thousandth of the median parameter's are left out of both: they move by
weight decay and round-off alone.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import counts, weights
from ..reference import sampling
from ..reference import train as ref_train
from . import frames

CHECK_STEPS = 3
NEGLIGIBLE = 1e-3


class _Steps:
    """``n`` batches of a running loader iterator, each ``next()`` a
    ``loader.next`` span: what ``Trainer.train`` takes as its loader."""

    def __init__(self, it, n, spans):
        self._it, self._n, self._spans = it, n, spans

    def __len__(self):
        return self._n

    def __iter__(self):
        for _ in range(self._n):
            with self._spans("loader.next"):
                item = next(self._it)
            yield item


def _epochs(loader):
    """The loader's batches, epoch after epoch."""
    while True:
        yield from loader


class _LossWriter:
    """The trainer's scalar writer: keeps each step's loss."""

    def __init__(self):
        self.losses = []

    def add_scalar(self, tag, value, step):
        if tag == "train/total_loss_step":
            self.losses.append(float(value))

    def flush(self):
        pass


def catalog(cfg, p, pool, rng):
    """``(tracklets, starts, lengths, pids, cams)`` of the training catalog."""
    n = cfg["num_train_tracklets"]
    lengths = frames.lognormal_lengths(np.random.RandomState(p["sizes_seed"]), n, p["length_mean"],
                                       p["length_sigma"], p["length_min"], p["length_max"])
    lengths = lengths[rng.permutation(n)]
    pids = rng.permutation(np.arange(n) % cfg["num_train_ids"])
    cams = rng.randint(0, cfg["num_cams"], n)
    tracklets, starts = frames.windows(pool, lengths, rng)
    items = [(f, int(pid), int(cam)) for f, pid, cam in zip(tracklets, pids, cams)]
    return items, starts, lengths, pids, cams


def models(cfg, device):
    from grl_tpu_torch.models import GRLModel, ResNetTrunk, Siamese, SiameseVideo

    with torch.device(device):
        cnn = GRLModel(trunk=ResNetTrunk(tuple(cfg["trunk_layers"]), width=cfg["trunk_width"]))
        siamese = Siamese(cfg["feat_dim"], cfg["siamese_out"])
        siamese_uncorr = SiameseVideo(cfg["feat_dim"], cfg["feat_dim"])
    return cnn, siamese, siamese_uncorr


def reference_batches(cfg, pool, starts, lengths, pids, cams, loader_seed, device, steps):
    """The first ``steps`` batches as the loader draws them."""
    b, t = cfg["train_batch"], cfg["seq_len"]
    order = sampling.pair_order(list(pids), list(cams), loader_seed, b * steps)
    out = []
    for k in range(steps):
        idx = order[k * b : (k + 1) * b]
        clips = np.stack([pool[starts[i] + sampling.rrs_train_indices(int(lengths[i]), t,
                                                                         sampling.item_rng(loader_seed, 0, i))]
                          for i in idx])
        out.append((torch.from_numpy(clips).to(device), torch.from_numpy(pids[idx].astype(np.int64))))
    return out


def gaps(prog, ref, keep):
    """The largest ``| |x| - |x_ref| | / max(|x_ref|, median |x_ref|)`` over
    the parameters in ``keep``."""
    ref_n = {k: float(ref[k].norm()) for k in keep}
    median = float(np.median(list(ref_n.values())))
    return max(abs(prog[k] - ref_n[k]) / max(ref_n[k], median) for k in keep)


def compare(losses, grads, changes, ref_losses, ref_grads, ref_changes):
    """The check's three numbers; ``grads``/``changes`` are the program's
    norms by parameter, the reference's are tensors."""
    g = {k: float(v.norm()) for k, v in ref_grads.items()}
    floor = NEGLIGIBLE * float(np.median(list(g.values())))
    keep = [k for k, v in g.items() if v >= floor]
    return {
        "loss_gap": max(abs(a - r) / abs(r) for a, r in zip(losses, ref_losses)),
        "grad_gap": gaps(grads, ref_grads, keep),
        "change_gap": gaps(changes, ref_changes, keep),
    }


def look(losses, grads, changes, ref_losses, ref_grads, ref_changes, top=5):
    """What the check's numbers are made of: each step's loss gap, and the
    parameters with the widest gradient and change gaps, with their
    reference norms against the median's."""
    g = {k: float(v.norm()) for k, v in ref_grads.items()}
    floor = NEGLIGIBLE * float(np.median(list(g.values())))
    keep = [k for k, v in g.items() if v >= floor]
    out = {"loss": [[a, r, abs(a - r) / abs(r)] for a, r in zip(losses, ref_losses)]}
    for name, prog, ref in (("grad", grads, ref_grads), ("change", changes, ref_changes)):
        ref_n = {k: float(ref[k].norm()) for k in keep}
        median = float(np.median(list(ref_n.values())))
        rows = sorted(((abs(prog[k] - ref_n[k]) / max(ref_n[k], median), k, ref_n[k] / median) for k in keep),
                      reverse=True)
        out[name] = [[k, gap, rel] for gap, k, rel in rows[:top]]
        out[name + "_median_gap"] = float(np.median([r[0] for r in rows]))
    return out


def reference_readings(wts, batches, cfg, aug_seed, precision, device, keep=None):
    gen = torch.Generator(device=device).manual_seed(aug_seed)
    losses, grads, after = ref_train.train_steps(
        wts, batches, gen, cfg["trunk_layers"], cfg["num_train_ids"], cfg["lr"], precision,
        cfg["momentum"], cfg["weight_decay"], keep=keep)
    return losses, grads, {k: after[k] - wts[k] for k in after}


def run(ctx, control=None):
    """One run (see the module docstring). ``control``: ``{name: precision
    or "half_batch"}`` of references put in the program's place; their
    readings come back as ``outcome.control`` (``reid_bench.control``)."""
    from grl_tpu_torch import set_precision
    from grl_tpu_torch.data.loader import ClipDataset, ClipLoader
    from grl_tpu_torch.data.sampling import RandomPairSampler
    from grl_tpu_torch.engine import Trainer
    from grl_tpu_torch.engine.train_step import init_train_state, make_train_step

    from ..run import Outcome
    from ..trace import DeviceTrace

    cfg, p, dev, spans = ctx.config, ctx.params, ctx.device, ctx.spans
    set_precision()
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    cnn, siamese, siamese_uncorr = models(cfg, dev)
    parts = (("cnn", cnn), ("siamese", siamese), ("siamese_uncorr", siamese_uncorr))
    wts = weights.generate(weights.shapes_of(*parts), ctx.subseed(2), dev)
    weights.load(wts, *parts)
    pool = frames.frame_pool(ctx.subseed(1), p["pool_frames"], cfg["height"], cfg["width"],
                             p["pool_segment"], p["noise"], dev)
    items, starts, lengths, pids, cams = catalog(cfg, p, pool, ctx.rng(3))
    loader_seed, aug_seed = ctx.subseed(4), ctx.subseed(5)
    loader = ClipLoader(ClipDataset(items, cfg["seq_len"], "rrs_train", cfg["height"], cfg["width"],
                                    seed=loader_seed),
                        batch_size=cfg["train_batch"], sampler=RandomPairSampler(items, seed=loader_seed),
                        drop_last=True, workers=p["workers"])
    state = init_train_state(cnn, siamese, siamese_uncorr, cfg["num_train_ids"], num_feat=cfg["feat_dim"],
                             momentum=cfg["momentum"], weight_decay=cfg["weight_decay"], device=dev)
    step = make_train_step(oim_scalar=cfg["oim_scalar"], oim_momentum=cfg["oim_momentum"],
                           verif_weight=cfg["verif_weight"], device=dev)
    writer = _LossWriter()
    trainer = Trainer(step, scalar_writer=writer, print_freq=10**9, seed=aug_seed, device=dev)
    lr = cfg["lr"]
    it = _epochs(loader)
    try:
        state, _ = trainer.train(0, state, _Steps(it, 1, spans), lr)
        named = dict(state.models.named_parameters())
        with torch.no_grad():
            # an optimizer that took no step holds no momentum: no gradient reached it
            bufs = {k: state.optimizer.state[q].get("momentum_buffer") for k, q in named.items()}
            grads = {k: 0.0 if b is None else float((b - cfg["weight_decay"] * wts[k]).norm())
                     for k, b in bufs.items()}
        state, _ = trainer.train(0, state, _Steps(it, CHECK_STEPS - 1, spans), lr)
        with torch.no_grad():
            changes = {k: float((q - wts[k]).norm()) for k, q in named.items()}
        losses = list(writer.losses)
        setup_s = time.time() - ctx.t0

        seconds = min(ctx.seconds, p["trace_seconds"]) if ctx.trace else ctx.seconds
        tracer = DeviceTrace(dev) if ctx.trace else None
        if tracer:
            tracer.__enter__()
        steps, data_wait = 0, 0.0
        start = time.perf_counter()
        while True:
            with spans("trainer.train"):
                state, stats = trainer.train(0, state, _Steps(it, p["chunk_steps"], spans), lr)
            steps += p["chunk_steps"]
            data_wait += stats["data_time"] * p["chunk_steps"]
            window = time.perf_counter() - start
            if window >= seconds:
                break
        if tracer:
            tracer.__exit__(None, None, None)
    finally:
        it.close()
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    del state, trainer, step, cnn, siamese, siamese_uncorr, named

    batches = reference_batches(cfg, pool, starts, lengths, pids, cams, loader_seed, dev, CHECK_STEPS)
    ref = reference_readings(wts, batches, cfg, aug_seed, "fp32", dev)
    limits = ctx.workload["limits"]
    found = compare(losses, grads, changes, *ref)
    out = Outcome(
        end_to_end={"train_clips_per_s": steps * cfg["train_batch"] / window}, setup_s=setup_s,
        attempted=steps, failed=0, checks={k: (v, limits[k]) for k, v in found.items()},
        memory_peak_bytes=peak, window_s=window, counters={"steps": steps, "data_wait_s": data_wait},
        ops={"step": counts.train_step_ops(cfg, cfg["train_batch"], cfg["num_train_ids"])},
        device_trace=tracer and tracer.timeline)
    if control is not None:
        out.control = {}
        ref_norms = lambda r: (r[0], {k: float(v.norm()) for k, v in r[1].items()},
                               {k: float(v.norm()) for k, v in r[2].items()})
        for name, how in control.items():
            if how == "half_batch":
                readings = reference_readings(wts, batches, cfg, aug_seed, "fp32", dev,
                                              keep=cfg["train_batch"] // 2)
            else:
                readings = reference_readings(wts, batches, cfg, aug_seed, how, dev)
            out.control[name] = compare(*ref_norms(readings), *ref)
        out.control["look"] = look(losses, grads, changes, *ref)
    return out
