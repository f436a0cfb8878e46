"""Flagship model: ResNet-50 + GCE + TRL with BN-neck outputs (counterpart
of ``grl_tpu/models/grl.py:19-60``)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .gce import GCEBackbone
from .trl import TRLBlock


class GRLModel(nn.Module):
    def __init__(self, trunk=None):
        super().__init__()
        self.backbone = GCEBackbone(trunk=trunk)
        num_feat = self.backbone.out_channels
        self.num_feat = num_feat
        self.temporal_learning_block = TRLBlock(num_feat)
        self.corr_bn = nn.BatchNorm1d(num_feat)
        self.uncorr_bn = nn.BatchNorm1d(num_feat)

    def forward(self, clips):
        """clips: (b, t, h, w, 3) float -> (x_uncorr (b, C), x_corr (b, t, C)),
        each L2-normalized as ``F.normalize`` does, x / max(‖x‖, 1e-12)."""
        b, t = clips.shape[:2]
        x_uncorr, x_corr, _ = self.backbone(clips)
        f_uncorr, f_corr = self.temporal_learning_block((x_uncorr, x_corr))
        f_corr = F.normalize(self.corr_bn(f_corr.reshape(b * t, -1)).view(b, t, -1), dim=2)
        f_uncorr = F.normalize(self.uncorr_bn(f_uncorr), dim=1)
        return f_uncorr, f_corr
