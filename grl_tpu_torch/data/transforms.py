"""Clip normalization (counterpart of ``grl_tpu/data/transforms.py:32-43``).

The evaluation path only normalizes; the training augmentations
(``random_flip``/``random_erase``) come with the training slice.
"""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(clips):
    """uint8/float (..., h, w, 3k) -> normalized float32, same layout.

    Channels beyond 3 are stacked modalities (RGB + optical flow); each
    3-channel group gets the same ImageNet stats."""
    x = clips.to(torch.float32) / 255.0
    reps = clips.shape[-1] // 3
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device).repeat(reps)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device).repeat(reps)
    return (x - mean) / std
