"""GCE — Global Correlation Estimation (counterpart of
``grl_tpu/models/gce.py:39-126``).

A clip-level global feature gates every frame's feature map into a
"correlated" and an "uncorrelated" stream through a 1-channel sigmoid mask:

- global feature = mean over (t, h, w) of the trunk output;
- ``glo_fc``: C -> C/2 linear + BN + ReLU;
- mask head ``corr_atte``: 1x1 convs over concat(frame map, broadcast
  global), C + C/2 -> C/2 -> C/8 -> 1, with BN (the last on the 1-channel
  logit), then a sigmoid;
- ``x_corr = x·m``, ``x_uncorr = x·(1−m)``.

The first mask conv is applied in split form: the frame half of its kernel
runs per pixel and the global half once per clip, entering as a broadcast
bias. It is the same linear map as the concat form without materializing
the (C + C/2)-channel concat. Under a ``compute_dtype`` the frame half runs
in that dtype and the global half is an fp32 product cast to it, as in
grl_tpu.
"""

from __future__ import annotations

from torch import nn

from ..nn import Conv2d, Linear, conv2d, sigmoid
from .resnet import resnet50_trunk


class GCEBackbone(nn.Module):
    """ResNet trunk + global-correlation split.

    forward input: (b, t, h, w, 3) float clips.
    Returns ``(x_uncorr, x_corr, corr_map)``, batch-major NCHW per frame:
    x_uncorr, x_corr (b, t, C, fh, fw); corr_map (b, t, 1, fh, fw).
    """

    def __init__(self, trunk=None, compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.compute_dtype = cd
        self.base = trunk if trunk is not None else resnet50_trunk(last_stride=1, compute_dtype=cd)
        ch = self.base.out_channels  # 2048 for ResNet-50
        glo = ch // 2
        mid = ch // 8
        self.out_channels = ch
        self.glo_fc = nn.Sequential(Linear(ch, glo, compute_dtype=cd), nn.BatchNorm1d(glo), nn.ReLU())
        self.corr_atte = nn.Sequential(
            Conv2d(ch + glo, glo, 1, bias=False, compute_dtype=cd),
            nn.BatchNorm2d(glo),
            Conv2d(glo, mid, 1, bias=False, compute_dtype=cd),
            nn.BatchNorm2d(mid),
            nn.ReLU(),
            Conv2d(mid, 1, 1, bias=False, compute_dtype=cd),
            nn.BatchNorm2d(1),
        )

    def forward(self, clips):
        b, t, h, w, c = clips.shape
        frames = clips.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w)
        x = self.base(frames)  # (b*t, C, fh, fw), frame bi*t + ti
        _, ch, fh, fw = x.shape

        glo = self.glo_fc(x.view(b, t, ch, fh, fw).mean(dim=(1, 3, 4)))  # (b, C/2)
        k = self.corr_atte[0].weight  # (C/2, C + C/2, 1, 1)
        h0 = conv2d(x, k[:, :ch], self.compute_dtype)
        # (b, C/2), once per clip: an fp32 (or wider) product in h0's dtype
        g0 = (glo.to(k.dtype) @ k[:, ch:, 0, 0].t()).to(h0.dtype)
        h0 = h0 + g0.repeat_interleave(t, dim=0)[:, :, None, None]
        logit = self.corr_atte[1:](h0)
        corr_map = sigmoid(logit)

        x_corr = x * corr_map
        x_uncorr = x * (1.0 - corr_map)
        to_clip = lambda a: a.view(b, t, a.shape[1], fh, fw)
        return to_clip(x_uncorr), to_clip(x_corr), to_clip(corr_map)
