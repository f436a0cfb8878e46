"""TRL — Temporal Reciprocal Learning (counterpart of
``grl_tpu/models/trl.py:50-204``).

Bidirectional recurrent enhancement of the correlated stream, driven by an
accumulating memory of the uncorrelated stream:

- each direction's memory starts as the temporal mean of the uncorrelated
  maps;
- per step: channel attention from the squared difference of 1x1-conv
  projections of memory and the current correlated frame, through an
  SE-style MLP C -> C/16 -> C with sigmoid; the enhanced frame
  ``x·atte + x`` is spatially pooled into the step's feature; the memory
  advances through a 1x1-conv residual block fed ``memory + uncorrelated
  frame``;
- outputs: per-frame features = forward + time-aligned backward features;
  clip-level uncorrelated feature = the pooled final memories of both
  directions, summed.

The recurrence is a Python loop over t. Two exact rewrites lift work out of
it: ``f2 = relu(conv(frame))`` does not depend on the memory, so it runs
once over all frames, and ``mean_hw(x·(1+atte)) = mean_hw(x)·(1+atte)``,
so the enhanced map is never formed.

Under a ``compute_dtype`` every conv and linear computes in that dtype, so
the memory carry, the step features and the squared differences are bf16,
as in grl_tpu's scan.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Conv2d, Linear, Sigmoid


class MemoryBlock(nn.Module):
    """1x1-conv residual block advancing the uncorrelated memory:
    C -> C/4 -> C/4 -> C with BN/ReLU and a residual from the input."""

    def __init__(self, channels=2048, bottleneck=512, compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.conv1 = Conv2d(channels, bottleneck, 1, bias=False, compute_dtype=cd)
        self.bn1 = nn.BatchNorm2d(bottleneck)
        self.conv2 = Conv2d(bottleneck, bottleneck, 1, bias=False, compute_dtype=cd)
        self.bn2 = nn.BatchNorm2d(bottleneck)
        self.conv3 = Conv2d(bottleneck, channels, 1, bias=False, compute_dtype=cd)
        self.bn3 = nn.BatchNorm2d(channels)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + x)


class _Direction(nn.Module):
    """One temporal direction: projections + SE attention + memory block."""

    def __init__(self, channels=2048, se_ratio=16, compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.f1 = Conv2d(channels, channels, 1, bias=True, compute_dtype=cd)
        self.f2 = Conv2d(channels, channels, 1, bias=True, compute_dtype=cd)
        self.atte = nn.Sequential(
            Linear(channels, channels // se_ratio, bias=False, compute_dtype=cd),
            nn.ReLU(),
            Linear(channels // se_ratio, channels, bias=False, compute_dtype=cd),
            Sigmoid(),
        )
        self.memo = MemoryBlock(channels, channels // 4, compute_dtype=cd)

    def forward(self, x_corr, x_uncorr, reverse=False):
        """x_corr / x_uncorr: (b, t, C, h, w). ``reverse=True`` runs the
        backward direction; each step's feature is written at its own time
        index, so the outputs of both directions are frame-aligned.
        Returns (f_steps (b, t, C), final memory (b, C, h, w))."""
        b, t, ch, h, w = x_corr.shape
        memo = x_uncorr.mean(dim=1)
        f2_all = F.relu(self.f2(x_corr.reshape(b * t, ch, h, w))).view(b, t, ch, h, w)
        xc_mean = x_corr.mean(dim=(3, 4))  # (b, t, C)

        f_steps = [None] * t
        for i in range(t - 1, -1, -1) if reverse else range(t):
            f1 = F.relu(self.f1(memo))
            diff = (f1 - f2_all[:, i]).square().mean(dim=(2, 3))
            f_steps[i] = xc_mean[:, i] * (1.0 + self.atte(diff))
            memo = self.memo(memo + x_uncorr[:, i])
        return torch.stack(f_steps, dim=1), memo


class TRLBlock(nn.Module):
    """Bidirectional TRL over a clip.

    forward input: ``(x_uncorr, x_corr)``, each (b, t, C, h, w).
    Returns ``(f_uncorr (b, C), f_corr (b, t, C))``.
    """

    def __init__(self, channels=2048, compute_dtype=None):
        super().__init__()
        self.fwd = _Direction(channels, compute_dtype=compute_dtype)
        self.bwd = _Direction(channels, compute_dtype=compute_dtype)

    def forward(self, x):
        x_uncorr, x_corr = x
        f_fwd, memo_f = self.fwd(x_corr, x_uncorr)
        f_bwd, memo_b = self.bwd(x_corr, x_uncorr, reverse=True)
        f_uncorr = memo_f.mean(dim=(2, 3)) + memo_b.mean(dim=(2, 3))
        return f_uncorr, f_fwd + f_bwd
