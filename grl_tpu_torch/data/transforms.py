"""Clip normalization and training augmentation on the device (counterpart
of ``grl_tpu/data/transforms.py``).

All ops run where the clips are, drawing from a ``torch.Generator`` on the
same device:
- flip: one p=0.5 decision per clip, all frames together;
- random erasing, per frame with p=0.5: area ratio U(0.02, 0.2), aspect
  U(0.3, 1/0.3), a solid random fill (one value per channel) at a position
  drawn uniformly;
  box sides are clamped to ``h - 1`` / ``w - 1`` (no rejection sampling);
- normalize: ImageNet mean/std after /255.

``random_flip``/``random_erase`` make the draws; ``flip``/``erase`` apply
given draws deterministically, so a test can feed them grl_tpu's.
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


def flip(clips, decision):
    """Mirror clip i (all its frames) where ``decision[i]``. clips: (b, t, h, w, c)."""
    return torch.where(decision[:, None, None, None, None], clips.flip(3), clips)


def random_flip(gen, clips):
    """Clip-consistent horizontal flip, p=0.5 per clip."""
    return flip(clips, torch.rand(clips.shape[0], generator=gen, device=clips.device) < 0.5)


def erase(clips, gate, area, aspect, ux, uy, color):
    """Erase one box per frame where ``gate``. clips: (b, t, h, w, c).

    Per frame (n = b·t): ``area`` in pixels, ``aspect`` = height/width,
    ``ux``/``uy`` in [0, 1) place the box's corner, ``color`` (n, c) fills
    it. Box corners are floats compared against integer pixel coordinates.
    """
    b, t, h, w, c = clips.shape
    n = b * t
    he = torch.clamp(torch.sqrt(area * aspect), max=h - 1)
    we = torch.clamp(torch.sqrt(area / aspect), max=w - 1)
    xe = ux * (w - we)
    ye = uy * (h - he)
    ys = torch.arange(h, dtype=torch.float32, device=clips.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=clips.device)[None, None, :]
    inside = (
        (xs >= xe[:, None, None])
        & (xs < (xe + we)[:, None, None])
        & (ys >= ye[:, None, None])
        & (ys < (ye + he)[:, None, None])
        & gate[:, None, None]
    )
    out = torch.where(inside[..., None], color.to(clips.dtype)[:, None, None, :], clips.reshape(n, h, w, c))
    return out.reshape(b, t, h, w, c)


def random_erase(gen, clips, sl=0.02, sh=0.2, asratio=0.3, p=0.5):
    """Per-frame random erasing on uint8-scale values. clips: (b, t, h, w, c)."""
    b, t, h, w, c = clips.shape
    n = b * t

    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=clips.device)

    gate = uniform() <= p
    area = uniform(sl, sh) * (h * w)
    aspect = uniform(asratio, 1.0 / asratio)
    ux, uy = uniform(), uniform()
    color = torch.randint(0, 256, (n, c), generator=gen, device=clips.device)
    return erase(clips, gate, area, aspect, ux, uy, color)


def augment(gen, clips_u8, train=True):
    """(b, t, h, w, c) uint8, c = 3 or 6 (RGB | flow) -> normalized float32;
    flip and erase when ``train``."""
    if train:
        clips_u8 = random_erase(gen, random_flip(gen, clips_u8))
    return normalize(clips_u8)
