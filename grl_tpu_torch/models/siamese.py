"""Siamese temporal pooling + pairwise verification heads (counterpart of
``grl_tpu/models/siamese.py``).

``Siamese``: QKV self-attention pooling over a clip's per-frame features:
Q/K are C -> 512 linear + BN + row-unit-norm projections, softmax(Q Kᵀ)
weights are applied to the raw C-dim frames, summed over time and
unit-normalized. The unit norms are the epsilon-free ``x / ‖x‖`` of
grl_tpu's ``l2_unit``, not ``F.normalize``. ``forward`` splits an
interleaved (anchor, positive) batch into probe/gallery halves, pools each,
and classifies every probe x gallery squared difference through BN + linear
into 2-way verification scores.

``SiameseVideo``: the same pairwise classifier for the clip-level (b, C)
uncorrelated stream, with no pooling.

Batch layout: pairs are adjacent (even index = probe, odd = gallery), as
the pair sampler yields them. Every child of the JAX modules is kept
(``featV``/``featV_bn`` are never applied) so a grl_tpu tree loads
strictly.

Under a ``compute_dtype`` the linears compute in that dtype; the attention
weights and the pooled sum are fp32 products of the (bf16) operands, as
grl_tpu's ``preferred_element_type=jnp.float32`` einsums, so ``Siamese``
pools into fp32 and its classifier takes fp32 differences, while
``SiameseVideo``'s take the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn import Linear, l2_unit


def pairwise_verification(classifier_bn, classifier_linear, probe, gallery):
    """All-pairs squared difference -> BN -> linear 2-way scores.

    probe (Np, C), gallery (Ng, C) -> (Np, Ng, 2)."""
    np_, ng = probe.shape[0], gallery.shape[0]
    diff = (probe[:, None, :] - gallery[None, :, :]).square().reshape(np_ * ng, -1)
    return classifier_linear(classifier_bn(diff)).view(np_, ng, -1)


def _linear(cin, cout, rule, compute_dtype):
    lin = Linear(cin, cout, compute_dtype=compute_dtype)
    lin.init_rule = rule
    return lin


class Siamese(nn.Module):
    def __init__(self, input_num=2048, output_num=512, class_num=2, compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.input_num = input_num
        self.output_num = output_num
        self.featQ = _linear(input_num, output_num, "kaiming_fan_out", cd)
        self.featQ_bn = nn.BatchNorm1d(output_num)
        self.featK = _linear(input_num, output_num, "kaiming_fan_out", cd)
        self.featK_bn = nn.BatchNorm1d(output_num)
        # featV is never applied (the raw frames are the values); kept for
        # checkpoint-shape compatibility
        self.featV = _linear(input_num, output_num, "kaiming_fan_out", cd)
        self.featV_bn = nn.BatchNorm1d(output_num)
        self.classifierBN = nn.BatchNorm1d(input_num)
        self.classifierlinear = _linear(input_num, class_num, "classifier", cd)

    def self_attention(self, x):
        """Attention-pool (b, t, C) -> (b, C), in fp32 (or wider)."""
        b, t, c = x.shape
        flat = x.reshape(b * t, c)
        q = l2_unit(self.featQ_bn(self.featQ(flat)), dim=1).view(b, t, -1)
        k = l2_unit(self.featK_bn(self.featK(flat)), dim=1).view(b, t, -1)
        # fp32 products of the compute-dtype operands (a bf16 x bf16
        # product is exact in fp32)
        wide = torch.promote_types(x.dtype, torch.float32)
        weights = torch.softmax(q.to(wide) @ k.to(wide).transpose(1, 2), dim=-1)
        pooled = (weights @ x.to(wide)).sum(dim=1)
        return l2_unit(pooled, dim=1)

    def forward(self, x):
        """x: (b, t, C) interleaved pairs -> (scores (b/2, b/2, 2), pooled (b, C)).

        In train mode the running statistics update in grl_tpu's order:
        probe pooling, gallery pooling (featQ_bn/featK_bn each twice), then
        classifierBN once."""
        b, t, c = x.shape
        pairs = x.view(b // 2, 2, t, c)
        pooled_probe = self.self_attention(pairs[:, 0])
        pooled_gallery = self.self_attention(pairs[:, 1])
        scores = pairwise_verification(self.classifierBN, self.classifierlinear,
                                       pooled_probe, pooled_gallery)
        return scores, torch.cat([pooled_probe, pooled_gallery])


class SiameseVideo(nn.Module):
    """Verification head for the (b, C) uncorrelated stream."""

    def __init__(self, input_num=2048, output_num=2048, class_num=2, compute_dtype=None):
        super().__init__()
        self.classifierBN = nn.BatchNorm1d(input_num)
        self.classifierlinear = _linear(input_num, class_num, "classifier", compute_dtype)

    def forward(self, x):
        """x: (b, C) interleaved pairs -> (scores (b/2, b/2, 2), (b, C) probes then galleries)."""
        pairs = x.view(x.shape[0] // 2, 2, -1)
        probe, gallery = pairs[:, 0], pairs[:, 1]
        scores = pairwise_verification(self.classifierBN, self.classifierlinear, probe, gallery)
        return scores, torch.cat([probe, gallery])
