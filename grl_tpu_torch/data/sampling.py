"""Clip sampling: restricted random sampling (RRS) grids and pair samplers.

RRS (reference reid/data/video_loader.py:36-50): a tracklet of ``num``
frames is split into ``S = seq_len`` equal chunks (padding by repeating the
last frame); training draws one random frame per chunk, testing takes each
chunk's first frame, and dense evaluation slides consecutive ``seq_len``
windows over the whole tracklet (last window cyclically padded,
video_loader.py:86-123).

``RandomPairSampler`` (reference reid/data/sampler.py:83-125): emits
tracklet indices in (anchor, positive) adjacent pairs — the positive is a
same-pid tracklet from a different camera when one exists, else any other
tracklet of the pid, else the anchor itself. The Siamese heads rely on this
interleaving.

Everything is seeded numpy on the host; no torch samplers. A copy of
``grl_tpu/data/sampling.py``: the port imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


def rrs_grid(num_frames, seq_len):
    """Chunk grid: list of ``seq_len`` frame-index pools."""
    idx = list(range(num_frames))
    if num_frames < seq_len:
        strip = idx + [idx[-1]] * (seq_len - num_frames)
        return [[strip[s]] for s in range(seq_len)]
    inter = math.ceil(num_frames / seq_len)
    strip = idx + [idx[-1]] * (inter * seq_len - num_frames)
    return [strip[inter * s : inter * (s + 1)] for s in range(seq_len)]


def rrs_train_indices(num_frames, seq_len, rng):
    grid = rrs_grid(num_frames, seq_len)
    return np.array([pool[rng.randint(len(pool))] for pool in grid])


def rrs_test_indices(num_frames, seq_len):
    grid = rrs_grid(num_frames, seq_len)
    return np.array([pool[0] for pool in grid])


def dense_indices(num_frames, seq_len):
    """All consecutive clips covering the tracklet: (n_clips, seq_len)."""
    idx = list(range(num_frames))
    clips, cur = [], 0
    while num_frames - cur > seq_len:
        clips.append(idx[cur : cur + seq_len])
        cur += seq_len
    last = idx[cur:]
    for i in last:
        if len(last) >= seq_len:
            break
        last.append(i)
    clips.append(last[:seq_len])
    return np.array(clips)


def random_window_indices(num_frames, seq_len, rng):
    """Consecutive random window with repeat-padding (video_loader.py:52-84)."""
    rand_end = max(0, num_frames - seq_len - 1)
    begin = rng.randint(0, rand_end + 1)
    end = min(begin + seq_len, num_frames)
    idx = list(range(begin, end))
    for i in idx:
        if len(idx) >= seq_len:
            break
        idx.append(i)
    return np.array(idx[:seq_len])


def _no_index(values, skip):
    return [i for i, v in enumerate(values) if v != skip]


class RandomPairSampler:
    """(anchor, positive) interleaved index stream over a tracklet catalog.

    ``dataset`` items are ``(frames, pid, camid)`` tuples. One epoch yields
    ``2 * len(dataset)`` indices.
    """

    def __init__(self, dataset, seed=0):
        self.num_samples = len(dataset)
        self.pids = [pid for _, pid, _ in dataset]
        self.cams = [cam for _, _, cam in dataset]
        self.pid_index = {}
        self.pid_cam = {}
        for index, (_, pid, cam) in enumerate(dataset):
            self.pid_index.setdefault(pid, []).append(index)
            self.pid_cam.setdefault(pid, []).append(cam)
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return self.num_samples * 2

    def __iter__(self):
        order = self.rng.permutation(self.num_samples)
        for i in order:
            i = int(i)
            yield i
            yield self.positive_for(i)

    def positive_for(self, i):
        pid, cam = self.pids[i], self.cams[i]
        cams = self.pid_cam[pid]
        index = self.pid_index[pid]
        if len(set(cams)) == 1:
            if len(index) == 1:
                choice = 0
            else:
                choice = self.rng.choice(_no_index(index, i))
        else:
            choice = self.rng.choice(_no_index(cams, cam))
        return index[int(choice)]


class RandomIdentitySampler:
    """N-identity x K-instance batches (reference reid/data/sampler.py:17-42 /
    samplers.py variants) — provided for the baseline model path."""

    def __init__(self, dataset, num_instances=4, seed=0):
        self.num_instances = num_instances
        self.pid_index = {}
        for index, (_, pid, _) in enumerate(dataset):
            self.pid_index.setdefault(pid, []).append(index)
        self.pids = list(self.pid_index.keys())
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.pids) * self.num_instances

    def __iter__(self):
        for p in self.rng.permutation(len(self.pids)):
            idx = self.pid_index[self.pids[int(p)]]
            replace = len(idx) < self.num_instances
            for j in self.rng.choice(idx, size=self.num_instances, replace=replace):
                yield int(j)
