"""The GRL training step: loss recipe, gradients, optimizer, OIM updates
(counterpart of ``grl_tpu/engine/train_step.py``).

Per step (the reference's SEQTrainer._forward):

1. frame-level OIM on the correlated stream, targets repeated over time;
2. Siamese attention pooling -> video-level OIM + soft batch-hard triplet
   on the pooled correlated features;
3. verification: 2-class cross-entropy of the pairwise scores, x20;
4. uncorrelated stream -> SiameseVideo head -> video-level OIM;
   total = (1) + (2) + (3) + (4).

The frame and video OIM share the ``corr`` lut, and the reference's OIM
mutates it in backward, video node first: the frame loss's VALUE uses the
original lut while its GRADIENT flows through the table after the video
update (``lut_mid``, built from detached features). After the optimizer
step the luts update in that order too: corr with the video features, corr
with the frame features, then uncorr.

Parameters the loss never reaches (``siamese.featV``/``featV_bn``,
``siamese_uncorr``'s classifier) get a zero gradient, and so weight decay
and momentum, as grl_tpu gives them; torch alone would leave their grad
``None`` and skip them.

The train state holds the modules, the luts, the optimizer and a step
counter; the step updates it in place and returns it with the metrics as
0-d tensors on the state's device (never read back inside the step).

Under a data-parallel group (``mesh``, ``parallel/mesh.py``) each rank
holds a contiguous slice of the global batch, and the step computes what
one card computes on the global batch: the CNN runs on the slice with
global-batch BatchNorm (``nn/norm.py``); one differentiable all-gather in
rank order gives every rank the CNN's outputs for the global batch, in
grl_tpu's batch order; the heads and losses (:func:`heads_loss_fn`) then
run unchanged on it, on every rank, with the global ids (gathered on the
host). Each rank back-propagates ``loss / ranks``: the gather's backward
sums every rank's copy of the loss, and the parameter gradients are then
summed over the ranks, so CNN and head gradients both come out those of
one card. Heads, luts and their BatchNorm statistics come out identical on
every rank with no further traffic.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from .. import losses, resolve_device
from ..nn import GlobalBatchNorm, all_gather_rows
from .optim import SGD, lr_mult_tree

_TRIPLET = losses.TripletLoss("soft", True)


def top1_accuracy(logits, targets):
    return (logits.argmax(dim=-1) == targets).to(torch.float32).mean()


class TrainState:
    """``models``: an ``nn.ModuleDict`` with ``cnn``, ``siamese`` and
    ``siamese_uncorr`` (so parameter names read ``cnn.backbone...`` as
    grl_tpu's param-tree paths do); ``luts``: ``{"corr", "uncorr"}``;
    ``optimizer``: :class:`SGD`; ``step``: steps taken."""

    def __init__(self, models, luts, optimizer, step=0):
        self.models = models
        self.luts = luts
        self.optimizer = optimizer
        self.step = step


def init_train_state(cnn, siamese, siamese_uncorr, num_classes, num_feat=2048, momentum=0.9,
                     weight_decay=5e-4, device=None):
    """The modules (moved to ``device``, default ``"cuda"``), zero luts, and
    SGD with lr_mult 1 on ``cnn.backbone`` and 2 elsewhere."""
    device = resolve_device(device)
    models = nn.ModuleDict({"cnn": cnn, "siamese": siamese, "siamese_uncorr": siamese_uncorr})
    models.to(device)
    luts = {k: losses.init_lut(num_classes, num_feat, device=device) for k in ("corr", "uncorr")}
    named = list(models.named_parameters())
    mults = lr_mult_tree(named, {"cnn.backbone": 1.0}, default=2.0)
    optimizer = SGD(named, mults, momentum=momentum, weight_decay=weight_decay, nesterov=True)
    return TrainState(models, luts, optimizer)


def grl_loss_fn(models, luts, clips, targets, *, rounds=None, oim_scalar=30.0, oim_momentum=0.5,
                verif_weight=20.0):
    """Returns ``(total_loss, aux)``; aux carries the detached features for
    the lut updates and the metrics. ``targets`` lie on the clips' device;
    ``rounds`` is ``losses.max_repeats`` of them, read on the host. The CNN
    (``models["cnn"]``), then :func:`heads_loss_fn` on its outputs."""
    x_uncorr, x_corr = models["cnn"](clips)
    return heads_loss_fn(models, luts, x_uncorr, x_corr, targets, rounds=rounds, oim_scalar=oim_scalar,
                         oim_momentum=oim_momentum, verif_weight=verif_weight)


def heads_loss_fn(models, luts, x_uncorr, x_corr, targets, *, rounds=None, oim_scalar=30.0, oim_momentum=0.5,
                  verif_weight=20.0):
    """The heads and the five loss terms on the CNN's outputs ``x_uncorr``
    (b, C) and ``x_corr`` (b, t, C) of the whole batch: every term is a
    function of the whole batch (the verification head scores every probe
    against every gallery clip, the triplet mines over the batch, the OIM
    means and lut updates run over its rows), so the group step gathers
    the CNN's outputs before calling it."""
    b, t = x_corr.shape[:2]

    # pair-interleaved verification targets
    tar_probe, tar_gallery = targets[0::2], targets[1::2]
    target = torch.cat([tar_probe, tar_gallery])

    # (2) video level: Siamese pooling -> OIM + triplet
    encode_scores, siamese_out = models["siamese"](x_corr)
    vid_logits = losses.oim_logits(siamese_out, luts["corr"], oim_scalar)
    corr_id_loss_vid = losses.cross_entropy(vid_logits, target)
    corr_loss_tri = _TRIPLET(siamese_out, target).mean()

    # (1) frame level: value from the original corr lut, gradient through
    # the table after the video update
    frame_corr = x_corr.reshape(b * t, -1)
    frame_targets = targets.repeat_interleave(t)
    lut_mid = losses.update_lut(luts["corr"], siamese_out, target, oim_momentum, rounds=rounds)
    value = losses.oim_logits(frame_corr, luts["corr"], oim_scalar)
    grad_path = losses.oim_logits(frame_corr, lut_mid, oim_scalar)
    frame_logits = grad_path + (value - grad_path).detach()
    corr_id_loss_frame = losses.cross_entropy(frame_logits, frame_targets)

    # (3) verification: 2-class cross-entropy of the raw scores
    corr_loss_ver, corr_prec_ver = losses.pair_loss_from_logits(encode_scores, tar_probe, tar_gallery)

    # (4) uncorrelated stream, video-level OIM (its verification scores
    # update classifierBN's running stats but stay out of the total)
    _, unc_out = models["siamese_uncorr"](x_uncorr)
    unc_logits = losses.oim_logits(unc_out, luts["uncorr"], oim_scalar)
    uncorr_id_loss_vid = losses.cross_entropy(unc_logits, target)

    total = (corr_id_loss_frame + corr_id_loss_vid + verif_weight * corr_loss_ver + corr_loss_tri
             + uncorr_id_loss_vid)
    metrics = {
        "loss": total,
        "loss_frame_oim": corr_id_loss_frame,
        "loss_vid_oim": corr_id_loss_vid,
        "loss_verif": corr_loss_ver,
        "loss_triplet": corr_loss_tri,
        "loss_uncorr_oim": uncorr_id_loss_vid,
        "prec_frame": top1_accuracy(frame_logits, frame_targets),
        "prec_vid": top1_accuracy(vid_logits, target),
        "prec_uncorr": top1_accuracy(unc_logits, target),
        "prec_verif": corr_prec_ver,
    }
    aux = {
        "lut_features": {
            "corr_vid": (siamese_out.detach(), target),
            "corr_frame": (frame_corr.detach(), frame_targets),
            "uncorr_vid": (unc_out.detach(), target),
        },
        "metrics": {k: v.detach() for k, v in metrics.items()},
    }
    return total, aux


def to_device(array, device):
    """Host array -> tensor on ``device``, through pinned memory on a card
    so the copy does not wait for the work already queued there."""
    t = torch.as_tensor(np.ascontiguousarray(array))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def _sum_gradients(params):
    """Sum every parameter's gradient over the ranks, one reduction per dtype."""
    by_dtype = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def _require_global_batchnorm(cnn):
    local = [name for name, m in cnn.named_modules()
             if isinstance(m, nn.modules.batchnorm._BatchNorm) and not isinstance(m, GlobalBatchNorm)]
    if local:
        raise ValueError(f"the group step needs parallel.sharded_train_state's state: cnn.{local[0]} "
                         "normalizes with its rank's statistics alone")


def make_train_step(*, oim_scalar=30.0, oim_momentum=0.5, verif_weight=20.0, device=None, mesh=None):
    """The train step ``(state, clips, targets, lr) -> (state, metrics)``.

    ``clips``: normalized float clips (b, t, h, w, 3) on ``device`` (default
    ``"cuda"``); ``targets``: the (b,) ids on the host, as the loader yields
    them (the lut updates' round counts come from them without a read-back).
    With ``mesh`` they are this rank's slice of the global batch, the state
    is ``parallel.sharded_train_state``'s (its CNN's BatchNorms global;
    the first step checks) and the step is the group step of the module
    docstring; the metrics are the global batch's, on every rank.
    """
    device = resolve_device(device) if mesh is None else mesh.device
    loss_kw = dict(oim_scalar=oim_scalar, oim_momentum=oim_momentum, verif_weight=verif_weight)
    checked = mesh is None

    def step(state, clips, targets, lr):
        nonlocal checked
        if not checked:
            _require_global_batchnorm(state.models["cnn"])
            checked = True
        ids = torch.as_tensor(targets).cpu().to(torch.int64)  # a card tensor is read back
        if mesh is not None:
            ids = torch.from_numpy(mesh.gather_host(ids.numpy()))
        rounds = losses.max_repeats(ids)
        t = clips.shape[1]
        targets = to_device(ids, device)
        clips = clips.to(device)

        state.models.train()
        opt = state.optimizer
        opt.set_lr(lr)
        opt.zero_grad(set_to_none=True)
        if mesh is None:
            total, aux = grl_loss_fn(state.models, state.luts, clips, targets, rounds=rounds, **loss_kw)
            total.backward()
        else:
            x_uncorr, x_corr = state.models["cnn"](clips)
            total, aux = heads_loss_fn(state.models, state.luts, all_gather_rows(x_uncorr),
                                       all_gather_rows(x_corr), targets, rounds=rounds, **loss_kw)
            (total / mesh.size).backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:  # unreached by the loss: zero grad, as in grl_tpu
                p.grad = torch.zeros_like(p)
        if mesh is not None:
            _sum_gradients(params)
        opt.step()

        # lut updates in the reference's backward order (video before frame)
        with torch.no_grad():
            feats = aux["lut_features"]
            corr = losses.update_lut(state.luts["corr"], *feats["corr_vid"], oim_momentum, rounds=rounds)
            corr = losses.update_lut(corr, *feats["corr_frame"], oim_momentum, rounds=rounds * t)
            uncorr = losses.update_lut(state.luts["uncorr"], *feats["uncorr_vid"], oim_momentum,
                                       rounds=rounds)
        state.luts = {"corr": corr, "uncorr": uncorr}
        state.step += 1
        return state, aux["metrics"]

    return step
