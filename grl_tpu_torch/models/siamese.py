"""Siamese temporal attention pooling (counterpart of
``grl_tpu/models/siamese.py:57-103``).

QKV self-attention pooling over a clip's per-frame features: Q/K are
C -> 512 linear + BN + row-unit-norm projections, softmax(Q Kᵀ) weights
are applied to the raw C-dim frames, summed over time and unit-normalized.
The unit norms are the epsilon-free ``x / ‖x‖`` of grl_tpu's ``l2_unit``,
not ``F.normalize``.

Every child of the JAX module is kept (``featV``, ``featV_bn``,
``classifierBN``, ``classifierlinear``) so a grl_tpu tree loads strictly;
the pairwise verification forward is training-path code and comes with
the training slice.
"""

from __future__ import annotations

import torch
from torch import nn


def l2_unit(x, dim):
    """x / ‖x‖ with no epsilon."""
    return x / x.square().sum(dim=dim, keepdim=True).sqrt()


def _linear(cin, cout, rule):
    lin = nn.Linear(cin, cout)
    lin.init_rule = rule
    return lin


class Siamese(nn.Module):
    def __init__(self, input_num=2048, output_num=512, class_num=2):
        super().__init__()
        self.input_num = input_num
        self.output_num = output_num
        self.featQ = _linear(input_num, output_num, "kaiming_fan_out")
        self.featQ_bn = nn.BatchNorm1d(output_num)
        self.featK = _linear(input_num, output_num, "kaiming_fan_out")
        self.featK_bn = nn.BatchNorm1d(output_num)
        # featV is never applied (the raw frames are the values); kept for
        # checkpoint-shape compatibility
        self.featV = _linear(input_num, output_num, "kaiming_fan_out")
        self.featV_bn = nn.BatchNorm1d(output_num)
        self.classifierBN = nn.BatchNorm1d(input_num)
        self.classifierlinear = _linear(input_num, class_num, "classifier")

    def self_attention(self, x):
        """Attention-pool (b, t, C) -> (b, C)."""
        b, t, c = x.shape
        flat = x.reshape(b * t, c)
        q = l2_unit(self.featQ_bn(self.featQ(flat)), dim=1).view(b, t, -1)
        k = l2_unit(self.featK_bn(self.featK(flat)), dim=1).view(b, t, -1)
        weights = torch.softmax(q @ k.transpose(1, 2), dim=-1)
        pooled = (weights @ x).sum(dim=1)
        return l2_unit(pooled, dim=1)
