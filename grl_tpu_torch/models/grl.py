"""Flagship model: ResNet-50 + GCE + TRL with BN-neck outputs (counterpart
of ``grl_tpu/models/grl.py:19-60``). ``compute_dtype`` reaches every conv
and linear of the backbone and TRL; a ``trunk`` passed in keeps its own."""

from __future__ import annotations

from torch import nn

from ..nn import l2_normalize
from .gce import GCEBackbone
from .trl import TRLBlock


class GRLModel(nn.Module):
    def __init__(self, trunk=None, compute_dtype=None):
        super().__init__()
        self.backbone = GCEBackbone(trunk=trunk, compute_dtype=compute_dtype)
        num_feat = self.backbone.out_channels
        self.num_feat = num_feat
        self.temporal_learning_block = TRLBlock(num_feat, compute_dtype=compute_dtype)
        self.corr_bn = nn.BatchNorm1d(num_feat)
        self.uncorr_bn = nn.BatchNorm1d(num_feat)

    def forward(self, clips):
        """clips: (b, t, h, w, 3) float -> (x_uncorr (b, C), x_corr (b, t, C)),
        each L2-normalized as ``F.normalize`` does, x / max(‖x‖, 1e-12), in fp32
        and returned in the compute dtype."""
        b, t = clips.shape[:2]
        x_uncorr, x_corr, _ = self.backbone(clips)
        f_uncorr, f_corr = self.temporal_learning_block((x_uncorr, x_corr))
        f_corr = l2_normalize(self.corr_bn(f_corr.reshape(b * t, -1)).view(b, t, -1), dim=2)
        f_uncorr = l2_normalize(self.uncorr_bn(f_uncorr), dim=1)
        return f_uncorr, f_corr
