"""Seeded frames, tracklet lengths and ids, shared by the traffic kinds.

The frames copy the synthetic catalog's generator (a low-frequency colour
template per identity, a camera tint, per-pixel noise; ``SyntheticVideoReID``
of the system's data catalogs) onto the device, and mix a template of each
frame's own into its segment's, so that consecutive frames, and so the
clips of one tracklet, differ. They form one pool, made on the device in a
few large calls and copied to the host once; tracklets are windows into
it. The ids and cameras are drawn as the system's bench draws its gallery's
(``randint`` of the id count and of the camera count from one
``RandomState``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

KNOTS = 4


def _templates(gen, n, h, w, device):
    """(n, 3, h, w) float templates: per channel, the outer product of a row
    and a column profile, each interpolated linearly between ``KNOTS``
    uniform knots."""
    row = torch.rand((n, 3, KNOTS), generator=gen, device=device)
    col = torch.rand((n, 3, KNOTS), generator=gen, device=device)
    rp = F.interpolate(row, size=h, mode="linear", align_corners=True)
    cp = F.interpolate(col, size=w, mode="linear", align_corners=True)
    return rp[:, :, :, None] * cp[:, :, None, :]


def frame_pool(seed, n_frames, height, width, segment, noise, device, block=1024):
    """(n_frames, height, width, 3) uint8 frames on the host: runs of
    ``segment`` frames share a template and a camera tint."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_seg = -(-n_frames // segment)
    seg = _templates(gen, n_seg, height, width, device)
    tint = 0.9 + 0.2 * torch.rand((n_seg,), generator=gen, device=device)
    out = np.empty((n_frames, height, width, 3), np.uint8)
    for lo in range(0, n_frames, block):
        hi = min(lo + block, n_frames)
        which = torch.arange(lo, hi, device=device) // segment
        own = _templates(gen, hi - lo, height, width, device)
        mixed = (0.6 * seg[which] + 0.4 * own) * tint[which, None, None, None]
        mixed = mixed + noise * torch.randn(mixed.shape, generator=gen, device=device)
        frames = (mixed.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
        out[lo:hi] = frames.permute(0, 2, 3, 1).cpu().numpy()
    return out


def lognormal_lengths(rng, n, mean, sigma, lo, hi):
    """``n`` tracklet lengths, log-normal with the given mean and log-sd,
    rounded and clipped to ``[lo, hi]``."""
    mu = np.log(mean) - sigma**2 / 2.0
    return np.clip(np.rint(rng.lognormal(mu, sigma, n)), lo, hi).astype(np.int64)


def ids_and_cams(rng, n, num_ids, num_cams):
    """``n`` (id, camera) pairs, the bench's draw."""
    return rng.randint(0, num_ids, n), rng.randint(0, num_cams, n)


def windows(pool, lengths, rng):
    """One tracklet per length: a window of the pool at a random start."""
    starts = rng.randint(0, pool.shape[0] - lengths + 1)
    return [pool[s : s + n] for s, n in zip(starts, lengths)], starts
