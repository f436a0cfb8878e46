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
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import losses, resolve_device
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
    ``rounds`` is ``losses.max_repeats`` of them, read on the host."""
    b, t = clips.shape[:2]
    x_uncorr, x_corr = models["cnn"](clips)

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


def make_train_step(*, oim_scalar=30.0, oim_momentum=0.5, verif_weight=20.0, device=None):
    """The train step ``(state, clips, targets, lr) -> (state, metrics)``.

    ``clips``: normalized float clips (b, t, h, w, 3) on ``device`` (default
    ``"cuda"``); ``targets``: the (b,) ids on the host, as the loader yields
    them (the lut updates' round counts come from them without a read-back).
    """
    device = resolve_device(device)

    def step(state, clips, targets, lr):
        ids = torch.as_tensor(targets).cpu().to(torch.int64)  # a card tensor is read back
        rounds = losses.max_repeats(ids)
        t = clips.shape[1]
        targets = to_device(ids, device)
        clips = clips.to(device)

        state.models.train()
        opt = state.optimizer
        opt.set_lr(lr)
        opt.zero_grad(set_to_none=True)
        total, aux = grl_loss_fn(state.models, state.luts, clips, targets, rounds=rounds,
                                 oim_scalar=oim_scalar, oim_momentum=oim_momentum,
                                 verif_weight=verif_weight)
        total.backward()
        for group in opt.param_groups:
            for p in group["params"]:
                if p.grad is None:  # unreached by the loss: zero grad, as in grl_tpu
                    p.grad = torch.zeros_like(p)
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
