"""Two-stream (RGB + optical flow) per-frame re-ID model (counterpart of
``grl_tpu/models/two_stream.py:31-105``).

Both modalities ride one (b, t, h, w, 6) clip, RGB on channels ``[:3]``
and flow on ``[3:]`` (``ClipDataset(flow_map=...)``). Each stream has its
own trunk (``rgb``, ``flow``), globally average-pooled per frame; the
pooled features are concatenated and take ``ResNetBaseline``'s heads.
A library model: ``--use-flow`` trains the GRL model on a 6-channel
trunk, not this, as in grl_tpu.
"""

from __future__ import annotations

import torch

from .resnet import ResNetTrunk, resnet50_trunk
from .resnet_baseline import FrameHeads, frames_nchw


class TwoStreamBaseline(FrameHeads):
    def __init__(self, num_features=512, rgb_trunk=None, flow_trunk=None, compute_dtype=None):
        rgb = rgb_trunk if rgb_trunk is not None else resnet50_trunk(last_stride=1, compute_dtype=compute_dtype)
        flow = flow_trunk if flow_trunk is not None else resnet50_trunk(last_stride=1, compute_dtype=compute_dtype)
        num_feat = rgb.out_channels + flow.out_channels
        super().__init__(num_feat, num_features, compute_dtype)
        self.rgb = rgb
        self.flow = flow
        self.num_features = num_features
        self.num_feat = num_feat

    def forward(self, clips):
        """clips: (b, t, h, w, 6) normalized float, RGB | flow ->
        (emb (b, t, F), raw (b, t, C_rgb + C_flow))."""
        b, t, _, _, c = clips.shape
        if c != 6:
            raise ValueError(f"two-stream clips need 6 channels (rgb|flow), got {c}")
        frames = frames_nchw(clips)
        x = torch.cat([self.rgb(frames[:, :3]).mean(dim=(2, 3)), self.flow(frames[:, 3:]).mean(dim=(2, 3))], dim=1)
        return self.heads(x, b, t)


def two_stream_tiny(num_features=16):
    """Tiny variant for tests and smoke runs."""
    return TwoStreamBaseline(num_features=num_features,
                             rgb_trunk=ResNetTrunk(layers=(1, 1, 1, 1), width=4),
                             flow_trunk=ResNetTrunk(layers=(1, 1, 1, 1), width=4))
