"""Soft-margin batch-hard triplet losses (counterpart of
``grl_tpu/losses/triplet.py``).

- euclidean distances in the Gram form, ``sqrt(max(sq, 0) + 1e-12)``;
- hardest positive = max distance over same-id pairs, diagonal excluded;
- hardest negative = min distance after adding 1e5 to same-id entries;
- soft margin ``log(1 + exp(z))`` per anchor (the caller takes the mean).

The reductions are ``amax``/``amin``, which split the gradient evenly among
tied entries as JAX's ``max``/``min`` do (``max(dim)`` would send it all to
one index).
"""

from __future__ import annotations

import torch


def euclidean_cdist(a, b):
    """Pairwise euclidean distances, (B1, D) x (B2, D) -> (B1, B2), in fp32
    or wider."""
    dtype = torch.promote_types(a.dtype, torch.float32)
    a, b = a.to(dtype), b.to(dtype)
    sq = a.square().sum(dim=1)[:, None] - 2.0 * (a @ b.T) + b.square().sum(dim=1)[None, :]
    # maximum, not clamp: at sq == 0 (a repeated feature) it passes half the
    # gradient, as JAX's does
    return torch.sqrt(torch.maximum(sq, sq.new_zeros(())) + 1e-12)


def _masks(ids):
    same = ids[:, None] == ids[None, :]
    eye = torch.eye(ids.shape[0], dtype=torch.bool, device=ids.device)
    return same, same & ~eye


def batch_hard(dist, same, positive):
    max_positive = torch.amax(dist * positive.to(dist.dtype), dim=1)
    min_negative = torch.amin(dist + 1e5 * same.to(dist.dtype), dim=1)
    return max_positive - min_negative


def soft_margin(z):
    return torch.logaddexp(torch.zeros_like(z), z)


def _margin_loss(z, margin):
    return soft_margin(z) if margin == "soft" else torch.clamp(z + margin, min=0.0)


class TripletLoss:
    """Soft-margin batch-hard triplet (margin='soft', batch_hard=True)."""

    def __init__(self, margin="soft", batch_hard=True):
        if not (margin == "soft" or isinstance(margin, float)):
            raise NotImplementedError(f"margin {margin!r} not recognized")
        self.margin = margin
        self.batch_hard = batch_hard

    def __call__(self, feat, ids):
        dist = euclidean_cdist(feat, feat)
        same, positive = _masks(ids)
        return _margin_loss(batch_hard(dist, same, positive), self.margin)


class TripletLossOIM:
    """Triplet against OIM lut class centers: distances are feature ->
    ``lut[ids]`` rows. The positive mask excludes the diagonal, as
    grl_tpu's (and the reference's) does, though ``dist[i, i]`` is the
    distance to feat_i's own center."""

    def __init__(self, margin="soft", batch_hard=True):
        self.margin = margin
        self.batch_hard = batch_hard

    def __call__(self, feat, lut, ids):
        dist = euclidean_cdist(feat, lut[ids])
        same, positive = _masks(ids)
        return _margin_loss(batch_hard(dist, same, positive), self.margin)
