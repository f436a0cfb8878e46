"""GRL's training step in plain PyTorch: the augmentation, the five loss
terms, the gradients by autograd, Nesterov SGD with weight decay and the
OIM lookup tables' update (mars_train.py and reid/trainer.py of
github.com/flysnowtiger/GRL).

Per step, on a batch of (anchor, positive) pairs:

1. frame-level OIM on the correlated frames; its value is read against
   the lookup table as it stood, its gradient flows through the table as
   the video-level OIM's backward leaves it (the reference's OIM updates
   the table inside backward, video node first);
2. video-level OIM and the soft-margin batch-hard triplet on the
   attention-pooled correlated stream;
3. 20 x the verification cross-entropy of every probe x gallery pair;
4. video-level OIM on the uncorrelated stream;

then SGD (momentum 0.9, weight decay 5e-4, Nesterov; learning rate x1 on
``cnn.backbone`` and x2 elsewhere), then the tables: corr with the video
features, corr with the frame features, uncorr, one row at a time in
batch order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .grl import Net, normalize

OIM_SCALAR = 30.0
OIM_MOMENTUM = 0.5
VERIF_WEIGHT = 20.0
BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def is_parameter(name):
    return name.rsplit(".", 1)[-1] not in BUFFERS


# -- the augmentation -----------------------------------------------------------
def augment(gen, clips_u8):
    """Flip each clip with p = 0.5, then erase one box in each frame with
    p = 0.5 (area U(0.02, 0.2) of the frame, aspect U(0.3, 1/0.3), a random
    colour per channel), drawing from ``gen`` in that order; returns the
    uint8 clips."""
    b, t, h, w, c = clips_u8.shape
    dev = clips_u8.device
    flip = torch.rand(b, generator=gen, device=dev) < 0.5
    clips = torch.where(flip[:, None, None, None, None], clips_u8.flip(3), clips_u8)
    n = b * t

    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    gate = uniform() <= 0.5
    area = uniform(0.02, 0.2) * (h * w)
    aspect = uniform(0.3, 1.0 / 0.3)
    ux, uy = uniform(), uniform()
    color = torch.randint(0, 256, (n, c), generator=gen, device=dev)
    he = torch.clamp(torch.sqrt(area * aspect), max=h - 1)
    we = torch.clamp(torch.sqrt(area / aspect), max=w - 1)
    x0, y0 = ux * (w - we), uy * (h - he)
    out = clips.reshape(n, h, w, c).clone()
    for i in range(n):
        if not gate[i]:
            continue
        ys = torch.arange(h, dtype=torch.float32, device=dev)
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        rows = (ys >= y0[i]) & (ys < y0[i] + he[i])
        cols = (xs >= x0[i]) & (xs < x0[i] + we[i])
        box = rows[:, None] & cols[None, :]
        out[i][box] = color[i].to(out.dtype)
    return out.reshape(b, t, h, w, c)


# -- the losses ---------------------------------------------------------------------
def lut_updated(lut, feats, targets):
    """The table after ``lut[y] <- normalize(m·lut[y] + (1 − m)·x)`` for each
    row in batch order (a new tensor)."""
    lut = lut.clone()
    for x, y in zip(feats, targets.tolist()):
        row = OIM_MOMENTUM * lut[y] + (1.0 - OIM_MOMENTUM) * x
        lut[y] = row / row.norm()
    return lut


def triplet_soft_batch_hard(net, feats, ids):
    sq = feats.square().sum(dim=1)
    gram = net.matmul(feats, feats.T)
    dist = torch.sqrt(torch.clamp(sq[:, None] - 2.0 * gram + sq[None, :], min=0.0) + 1e-12)
    same = ids[:, None] == ids[None, :]
    positive = same & ~torch.eye(len(ids), dtype=torch.bool, device=ids.device)
    hardest_pos = torch.amax(dist * positive.to(dist.dtype), dim=1)
    hardest_neg = torch.amin(dist + 1e5 * same.to(dist.dtype), dim=1)
    z = hardest_pos - hardest_neg
    return torch.logaddexp(torch.zeros_like(z), z).mean()


def loss(net, clips, targets, luts, layers):
    """(total, lut features) of one step. ``clips``:
    normalized (b, t, h, w, 3); ``targets``: (b,) ids, pairs interleaved."""
    f_uncorr, f_corr = net.grl(clips, layers)
    b, t, ch = f_corr.shape
    tar_probe, tar_gallery = targets[0::2], targets[1::2]
    target = torch.cat([tar_probe, tar_gallery])

    pairs = f_corr.view(b // 2, 2, t, ch)
    probe = net.attention_pool("siamese", pairs[:, 0])
    gallery = net.attention_pool("siamese", pairs[:, 1])
    pooled = torch.cat([probe, gallery])
    scores = net.verification("siamese", probe, gallery)

    vid_logits = OIM_SCALAR * net.matmul(pooled, luts["corr"].T)
    vid_oim = F.cross_entropy(vid_logits, target)
    triplet = triplet_soft_batch_hard(net, pooled, target)

    frames = f_corr.reshape(b * t, ch)
    frame_targets = targets.repeat_interleave(t)
    lut_mid = lut_updated(luts["corr"], pooled.detach(), target)
    value = OIM_SCALAR * net.matmul(frames, luts["corr"].T)
    through_mid = OIM_SCALAR * net.matmul(frames, lut_mid.T)
    frame_oim = F.cross_entropy(through_mid + (value - through_mid).detach(), frame_targets)

    same = (tar_probe[:, None] == tar_gallery[None, :]).to(scores.dtype)
    logp = torch.log_softmax(scores, dim=-1)
    verif = -torch.mean(same * logp[..., 1] + (1.0 - same) * logp[..., 0])

    unc = torch.cat([f_uncorr[0::2], f_uncorr[1::2]])
    unc_oim = F.cross_entropy(OIM_SCALAR * net.matmul(unc, luts["uncorr"].T), target)

    total = frame_oim + vid_oim + VERIF_WEIGHT * verif + triplet + unc_oim
    lut_feats = [(pooled.detach(), target), (frames.detach(), frame_targets), (unc.detach(), target)]
    return total, lut_feats


def train_steps(w0, batches, gen, layers, num_classes, lr, precision="fp32", momentum=0.9,
                weight_decay=5e-4, keep=None):
    """Take ``len(batches)`` steps from the weights ``w0`` (left as they
    are). ``batches``: ``(uint8 clips (b, t, h, w, 3), ids (b,))`` on the
    device; ``gen``: the augmentation's generator; ``keep``: how many of a
    batch's rows the step then trains on (all of them by default). Returns
    ``(losses, first gradients, weights after the last step)``, the
    gradients and weights as ``{name: tensor}`` of the parameters."""
    names = [k for k in w0 if is_parameter(k)]
    w = {k: v.detach().clone().requires_grad_(is_parameter(k) and v.is_floating_point())
         for k, v in w0.items()}
    ch = w["cnn.corr_bn.weight"].shape[0]
    dev = w["cnn.corr_bn.weight"].device
    luts = {k: torch.zeros((num_classes, ch), dtype=torch.float32, device=dev) for k in ("corr", "uncorr")}
    bufs, losses, first_grads = {}, [], None
    for clips_u8, ids in batches:
        net = Net(w, mode="train", precision=precision)
        clips = normalize(augment(gen, clips_u8))[:keep]
        total, lut_feats = loss(net, clips, ids.to(dev).long()[:keep], luts, layers)
        params = [w[k] for k in names]
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if first_grads is None:
            first_grads = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, p, g in zip(names, params, grads):
                d = g + weight_decay * p
                bufs[k] = d.clone() if k not in bufs else momentum * bufs[k] + d
                mult = 1.0 if k.startswith("cnn.backbone.") else 2.0
                p -= lr * mult * (d + momentum * bufs[k])
            corr = lut_updated(luts["corr"], *lut_feats[0])
            corr = lut_updated(corr, *lut_feats[1])
            luts = {"corr": corr, "uncorr": lut_updated(luts["uncorr"], *lut_feats[2])}
        losses.append(float(total.detach()))
    return losses, first_grads, {k: w[k].detach() for k in names}
