"""ResNet backbone (v1.5 bottlenecks), last-stage stride configurable.

Counterpart of ``grl_tpu/models/resnet.py:30-127``. The re-ID variant fixes
layer4 at stride 1, so a 256x128 input yields a 16x8x2048 feature map.
Activations are NCHW inside the port; submodule names follow grl_tpu's
param tree (``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``
...) so the weight bridge maps every key one to one.

Under a ``compute_dtype`` (bf16) every conv computes in that dtype; BatchNorm keeps fp32 statistics and
returns the input's dtype, as grl_tpu's does. ``in_channels=6`` is the
RGB|flow packing of ``--use-flow``: only conv1 widens.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ..nn import Conv2d


def _conv(cin, cout, ks, stride=1, padding=0, compute_dtype=None):
    conv = Conv2d(cin, cout, ks, stride=stride, padding=padding, bias=False, compute_dtype=compute_dtype)
    conv.init_rule = "resnet_normal"
    return conv


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 bottleneck with optional downsample."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False, compute_dtype=None):
        super().__init__()
        cd = compute_dtype
        self.conv1 = _conv(inplanes, planes, 1, compute_dtype=cd)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride=stride, padding=1, compute_dtype=cd)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = _conv(planes, planes * 4, 1, compute_dtype=cd)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(inplanes, planes * 4, 1, stride=stride, compute_dtype=cd),
                          nn.BatchNorm2d(planes * 4))
            if downsample
            else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(out + residual)


class ResNetTrunk(nn.Module):
    """conv1..layer4 feature trunk (no avgpool/fc: the re-ID path never uses
    them). Input and output are NCHW."""

    def __init__(self, layers=(3, 4, 6, 3), last_stride=1, width=64, compute_dtype=None, in_channels=3):
        super().__init__()
        self.in_channels = in_channels
        self.conv1 = _conv(in_channels, width, 7, stride=2, padding=3, compute_dtype=compute_dtype)
        self.bn1 = nn.BatchNorm2d(width)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = width
        strides = (1, 2, 2, last_stride)
        planes_list = (width, width * 2, width * 4, width * 8)
        for li, (planes, blocks, stride) in enumerate(zip(planes_list, layers, strides), start=1):
            mods = []
            for bi in range(blocks):
                s = stride if bi == 0 else 1
                ds = bi == 0 and (s != 1 or inplanes != planes * 4)
                mods.append(Bottleneck(inplanes, planes, stride=s, downsample=ds, compute_dtype=compute_dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*mods))
        self.out_channels = inplanes

    def forward(self, x):
        # conv1 casts the input: grl_tpu's entry cast (models/resnet.py:113-114)
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        return self.layer4(self.layer3(self.layer2(self.layer1(x))))


def resnet50_trunk(last_stride=1, compute_dtype=None, in_channels=3):
    return ResNetTrunk((3, 4, 6, 3), last_stride=last_stride, compute_dtype=compute_dtype,
                       in_channels=in_channels)
