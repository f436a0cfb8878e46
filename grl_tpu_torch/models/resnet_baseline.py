"""Per-frame ResNet-50 re-ID baseline (counterpart of
``grl_tpu/models/resnet_baseline.py:25-70``).

Per frame: trunk (last stride 1) -> global average pool -> two heads:
- ``raw``: ``feat_bn2`` then L2, shaped (b, t, C);
- ``emb``: ``feat`` (C -> num_features, kaiming-uniform on fan-out, zero
  bias) then ``feat_bn`` then L2, shaped (b, t, num_features); with
  ``num_features=0`` it is ``raw``.

Returns ``(emb, raw)``. The unit norms are grl_tpu's epsilon-free
``l2_unit``. A library model: no CLI trains it, as in grl_tpu.
"""

from __future__ import annotations

from torch import nn

from ..nn import Linear, l2_unit
from .resnet import resnet50_trunk


def frames_nchw(clips):
    """(b, t, h, w, c) -> (b·t, c, h, w), frame bi·t + ti."""
    b, t, h, w, c = clips.shape
    return clips.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w)


class FrameHeads(nn.Module):
    """The baselines' two heads over pooled per-frame features (b·t, C)."""

    def __init__(self, num_feat, num_features, compute_dtype=None):
        super().__init__()
        self.feat_bn2 = nn.BatchNorm1d(num_feat)
        self.has_embedding = num_features > 0
        if self.has_embedding:
            self.feat = Linear(num_feat, num_features, compute_dtype=compute_dtype)
            self.feat.init_rule = "kaiming_fan_out"
            self.feat_bn = nn.BatchNorm1d(num_features)

    def heads(self, x, b, t):
        raw = l2_unit(self.feat_bn2(x), dim=1).view(b, t, -1)
        if not self.has_embedding:
            return raw, raw
        return l2_unit(self.feat_bn(self.feat(x)), dim=1).view(b, t, -1), raw


class ResNetBaseline(FrameHeads):
    def __init__(self, num_features=512, compute_dtype=None):
        base = resnet50_trunk(last_stride=1, compute_dtype=compute_dtype)
        super().__init__(base.out_channels, num_features, compute_dtype)
        self.base = base
        self.num_features = num_features

    def forward(self, clips):
        """clips: (b, t, h, w, c) float -> (emb (b, t, F), raw (b, t, C))."""
        b, t = clips.shape[:2]
        x = self.base(frames_nchw(clips)).mean(dim=(2, 3))
        return self.heads(x, b, t)
