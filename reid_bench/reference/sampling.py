"""Which frames a clip holds, and which tracklets a training batch holds,
as the GRL reference's loaders choose them (reid/data/video_loader.py and
reid/data/sampler.py of github.com/flysnowtiger/GRL), with the per-item
random streams the system seeds them from:

- dense evaluation slides consecutive windows of ``seq_len`` frames over
  a tracklet, the last one padded cyclically;
- restricted random sampling splits a tracklet into ``seq_len`` equal
  chunks (the last frame repeated to fill them) and draws one frame from
  each, from a ``RandomState`` seeded by splitmix64 of (seed, epoch, item);
- the pair sampler visits the tracklets in a seeded permutation and puts
  after each one a positive: a tracklet of the same id from another
  camera, else another tracklet of the id, else itself.
"""

from __future__ import annotations

import math

import numpy as np

MASK64 = 0xFFFFFFFFFFFFFFFF


def dense_indices(num_frames, seq_len):
    """(n_clips, seq_len) frame indices of the dense windows."""
    starts = range(0, max(num_frames - 1, 0) // seq_len * seq_len + 1, seq_len)
    clips = []
    for s in starts:
        window = list(range(s, min(s + seq_len, num_frames)))
        while len(window) < seq_len:
            window = (window * 2)[:seq_len]
        clips.append(window)
    return np.array(clips)


def item_rng(seed, epoch, index):
    x = (seed * (2**42) + epoch * (2**28) + index) & MASK64
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return np.random.RandomState((x ^ (x >> 31)) % (2**31 - 1))


def rrs_train_indices(num_frames, seq_len, rng):
    frames = list(range(num_frames))
    chunk = 1 if num_frames < seq_len else math.ceil(num_frames / seq_len)
    frames += [frames[-1]] * (chunk * seq_len - num_frames)
    return np.array([frames[s * chunk + rng.randint(chunk)] for s in range(seq_len)])


def pair_order(pids, cams, seed, count):
    """The first ``count`` tracklet indices of the pair sampler's first epoch."""
    rng = np.random.RandomState(seed)
    by_pid = {}
    for i, p in enumerate(pids):
        by_pid.setdefault(p, []).append(i)
    out = []
    for i in rng.permutation(len(pids)):
        if len(out) >= count:
            break
        i = int(i)
        members = by_pid[pids[i]]
        other_cams = [j for j, m in enumerate(members) if cams[m] != cams[i]]
        if other_cams:
            pick = members[int(rng.choice(other_cams))]
        elif len(members) > 1:
            pick = members[int(rng.choice([j for j, m in enumerate(members) if m != i]))]
        else:
            pick = i
        out += [i, pick]
    return out[:count]
