"""Synthetic tracklet catalog — in-memory fake MARS.

A copy of ``grl_tpu/data/catalogs/synthetic.py``: deterministic
per-identity visual templates with per-frame noise and camera-dependent
tint, variable tracklet lengths, MARS-shaped splits (train with relabeled
pids; query ⊂ test ids; gallery covering all test ids across cameras).
The same seed gives the same frames in both packages.
"""

from __future__ import annotations

import numpy as np


class InfoStruct:
    """Attribute bag for split metadata (``grl_tpu/data/catalogs/mars.py:23``)."""


def _template(rng, h, w):
    """Low-frequency colored pattern, distinctive per identity."""
    knots = 4
    row = rng.rand(knots, 3)
    col = rng.rand(knots, 3)
    ys = np.linspace(0, knots - 1, h)
    xs = np.linspace(0, knots - 1, w)
    grid = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        rp = np.interp(ys, np.arange(knots), row[:, c])
        cp = np.interp(xs, np.arange(knots), col[:, c])
        grid[..., c] = rp[:, None] * cp[None, :]
    return grid


class SyntheticVideoReID:
    def __init__(
        self,
        num_train_ids=4,
        num_test_ids=3,
        tracklets_per_id=2,
        num_cams=2,
        frames_range=(6, 14),
        height=64,
        width=32,
        seed=0,
        noise=0.08,
    ):
        rng = np.random.RandomState(seed)
        self.height, self.width = height, width
        total_ids = num_train_ids + num_test_ids
        templates = [_template(rng, height, width) for _ in range(total_ids)]

        def make_tracklet(gid, cam):
            n = rng.randint(*frames_range)
            tint = 0.9 + 0.2 * (cam / max(num_cams - 1, 1))
            frames = np.clip(
                (templates[gid] * tint + noise * rng.randn(n, height, width, 3)) * 255,
                0,
                255,
            ).astype(np.uint8)
            return frames

        self.train = []
        for pid in range(num_train_ids):
            for cam in range(num_cams):
                for _ in range(tracklets_per_id):
                    self.train.append((make_tracklet(pid, cam), pid, cam))

        self.query, self.gallery = [], []
        q_pid, q_cam, g_pid, g_cam = [], [], [], []
        for ti in range(num_test_ids):
            gid = num_train_ids + ti
            pid = 1000 + ti  # raw (un-relabeled) test pid, like MARS
            for cam in range(num_cams):
                for k in range(tracklets_per_id):
                    t = (make_tracklet(gid, cam), pid, cam)
                    if cam == 0 and k == 0:
                        # queries are excluded from the catalog gallery,
                        # like MARS's positional query_IDX split: the
                        # evaluator re-adds them (gallery = query ∪ gallery)
                        self.query.append(t)
                        q_pid.append(pid)
                        q_cam.append(cam)
                    else:
                        self.gallery.append(t)
                        g_pid.append(pid)
                        g_cam.append(cam)

        self.num_train_pids = num_train_ids
        self.num_query_pids = num_test_ids
        self.num_gallery_pids = num_test_ids
        self.queryinfo = InfoStruct()
        self.queryinfo.pid, self.queryinfo.camid = q_pid, q_cam
        self.galleryinfo = InfoStruct()
        self.galleryinfo.pid, self.galleryinfo.camid = g_pid, g_cam
