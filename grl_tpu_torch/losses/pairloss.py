"""Pairwise verification BCE (counterpart of ``grl_tpu/losses/pairloss.py``).

The label matrix is probe/gallery id equality; each function returns
``(loss, accuracy)`` as 0-d tensors.
"""

from __future__ import annotations

import torch


def _labels(tar_probe, tar_gallery):
    return (tar_probe[:, None] == tar_gallery[None, :]).to(torch.float32)


def pair_loss(scores, tar_probe, tar_gallery):
    """scores: (Np, Ng) match probabilities in [0, 1]; each log term is
    clamped at -100 as ``torch.nn.BCELoss`` does."""
    y = _labels(tar_probe, tar_gallery).reshape(-1)
    p = scores.reshape(-1).to(torch.float32)
    loss = -torch.mean(
        y * torch.clamp(torch.log(p), min=-100.0) + (1.0 - y) * torch.clamp(torch.log1p(-p), min=-100.0)
    )
    acc = ((p > 0.5) == (y > 0.5)).to(torch.float32).mean()
    return loss, acc


def pair_loss_from_logits(scores, tar_probe, tar_gallery):
    """The same loss from the raw 2-way scores (Np, Ng, 2).

    softmax + BCE on the class-1 probability is the 2-class cross-entropy of
    the logits; through log_softmax its gradient (p − y) stays finite when
    the probabilities saturate, where the probability form gives 0·inf.
    """
    labels = _labels(tar_probe, tar_gallery)
    logp = scores - torch.logsumexp(scores, dim=-1, keepdim=True)
    loss = -torch.mean(labels * logp[..., 1] + (1.0 - labels) * logp[..., 0])
    p1 = torch.exp(logp[..., 1])
    acc = ((p1 > 0.5) == (labels > 0.5)).to(torch.float32).mean()
    return loss, acc


class PairLoss:
    def __call__(self, scores, tar_probe, tar_gallery):
        return pair_loss(scores, tar_probe, tar_gallery)
