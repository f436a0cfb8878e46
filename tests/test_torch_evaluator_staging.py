"""The dense evaluator's staging on the CPU (``Evaluator._extract_dense``).

Each micro-batch is copied once, into the next of two reused staging
slots, instead of concatenating the pending clips: the clips and ids that
reach the descriptor and the per-tracklet sums are held byte for byte
against the concatenating packer it replaced, over a tracklet split across
three micro-batches, a carried remainder and a short last micro-batch,
and the features are held equal to that packer's.
"""

import numpy as np
import pytest
import torch

from grl_tpu_torch import models as tm
from grl_tpu_torch.data import ClipDataset, ClipLoader
from grl_tpu_torch.engine import Evaluator

SEQ_LEN, H, W = 2, 32, 16

# clip counts a tracklet at micro-batch 4 (frames = 2 × clips):
CASES = {
    # 2 | 2 + 4 + 4 (the 10-clip tracklet over three micro-batches) | ...
    "split_over_three": ((2, 10, 3, 1), 4),
    # 3 clips carried after each full micro-batch, then a short last one
    "carried_remainder": ((7, 6, 1, 5), 4),
    # every tracklet shorter than a micro-batch; 6 clips, so the last is short
    "short_last": ((1, 2, 1, 2), 4),
    # one tracklet of exactly one micro-batch, then another of one clip
    "whole_then_one": ((4, 1), 4),
}


def _evaluator(micro_batch, channels=3):
    torch.manual_seed(0)
    cnn = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=2, in_channels=channels))
    siamese = tm.Siamese(input_num=cnn.num_feat, output_num=8)
    return Evaluator(cnn, siamese, micro_batch=micro_batch, device="cpu")


def _items(clip_counts, seed=0, channels=3, frame=(H, W)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, (n * SEQ_LEN, *frame, channels), np.uint8), i, i % 2)
            for i, n in enumerate(clip_counts)]


def _loader(items, frame=(H, W)):
    return ClipLoader(ClipDataset(items, SEQ_LEN, "dense", *frame), batch_size=1, workers=1)


def concatenating_packer(loader, mb):
    """The micro-batches ``(clips, ids)`` that the concatenating packer
    handed on: each tracklet's clips appended, and every ``mb`` of them
    cut from ``np.concatenate`` of all pending ones, the rest carried."""
    out, pend_clips, pend_ids, pending = [], [], [], 0
    for item, (clips, _, _) in enumerate(loader):
        pend_clips.append(clips)
        pend_ids.append(np.full(clips.shape[0], item, np.int64))
        pending += clips.shape[0]
        while pending >= mb:
            clips_np, ids_np = np.concatenate(pend_clips), np.concatenate(pend_ids)
            out.append((clips_np[:mb], ids_np[:mb]))
            pend_clips, pend_ids = [clips_np[mb:]], [ids_np[mb:]]
            pending -= mb
    if pending:
        out.append((np.concatenate(pend_clips), np.concatenate(pend_ids)))
    return out


def concatenating_features(ev, loader, n_items):
    """The features of the concatenating packer's micro-batches, through the
    evaluator's descriptor and ``index_add_`` in the same order."""
    buf, counts = None, np.zeros(n_items, np.float32)
    with torch.inference_mode():
        for clips, ids in concatenating_packer(loader, ev.micro_batch):
            d = ev._describe(torch.from_numpy(clips))
            if buf is None:
                buf = torch.zeros((n_items, d.shape[1]), dtype=d.dtype)
            buf.index_add_(0, torch.from_numpy(ids), d)
            np.add.at(counts, ids, 1)
        return buf / torch.from_numpy(counts)[:, None]


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_micro_batch_reaches_the_descriptor_as_the_concatenating_packer_cut_it(case, monkeypatch):
    clip_counts, mb = CASES[case]
    items = _items(clip_counts)
    want = concatenating_packer(_loader(items), mb)
    ev = _evaluator(mb)
    described, added = [], []
    real_describe, real_index_add = ev._describe, torch.Tensor.index_add_

    def describe(chunk):
        described.append(chunk.clone())  # the slot is refilled two micro-batches on
        return real_describe(chunk)

    def index_add_(self, dim, index, source, **kw):
        added.append(index.clone())
        return real_index_add(self, dim, index, source, **kw)

    monkeypatch.setattr(ev, "_describe", describe)
    monkeypatch.setattr(torch.Tensor, "index_add_", index_add_)
    feats, pids, _ = ev.extract_features(_loader(items))
    monkeypatch.undo()
    assert len(described) == len(added) == len(want) == -(-sum(clip_counts) // mb)
    for (clips, ids), got_clips, got_ids in zip(want, described, added):
        assert got_clips.dtype == torch.uint8 and got_clips.shape == clips.shape
        assert got_clips.numpy().tobytes() == clips.tobytes()
        assert got_ids.dtype == torch.int64 and got_ids.numpy().tobytes() == ids.tobytes()
    assert feats.shape[0] == len(clip_counts) and list(pids) == list(range(len(clip_counts)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_features_equal_the_concatenating_packers(case):
    clip_counts, mb = CASES[case]
    items = _items(clip_counts, seed=1)
    ev = _evaluator(mb)
    feats, _, _ = ev.extract_features(_loader(items))
    assert torch.equal(feats, concatenating_features(ev, _loader(items), len(items)))


def test_the_slots_are_kept_across_calls_and_made_anew_for_another_clip_shape():
    ev = _evaluator(4)
    ev.extract_features(_loader(_items((3, 5))))
    first = ev._slots
    ev.extract_features(_loader(_items((6, 1), seed=2)))
    assert ev._slots is first
    (key, slots) = first
    assert key == (4, (SEQ_LEN, H, W, 3), torch.uint8) and len(slots) == 2
    assert all(s.clips.shape == (4, SEQ_LEN, H, W, 3) and not s.clips.is_pinned() and s.uploaded is None
               and s.device_clips is s.clips for s in slots)
    # another frame size, then another micro-batch: new slots, the same answers
    small = _items((5, 2), seed=3, frame=(16, 8))
    feats, _, _ = ev.extract_features(_loader(small, frame=(16, 8)))
    assert ev._slots[0] == (4, (SEQ_LEN, 16, 8, 3), torch.uint8)
    assert torch.equal(feats, concatenating_features(ev, _loader(small, frame=(16, 8)), len(small)))
    ev.micro_batch = 3
    feats, _, _ = ev.extract_features(_loader(small, frame=(16, 8)))
    assert ev._slots[0] == (3, (SEQ_LEN, 16, 8, 3), torch.uint8)
    assert torch.equal(feats, concatenating_features(ev, _loader(small, frame=(16, 8)), len(small)))


def test_flow_clips_take_slots_of_their_own_six_channels():
    ev = _evaluator(4, channels=6)
    flow = _items((5, 2, 6), seed=4, channels=6)
    feats, _, _ = ev.extract_features(_loader(flow))
    assert ev._slots[0] == (4, (SEQ_LEN, H, W, 6), torch.uint8)
    assert torch.equal(feats, concatenating_features(ev, _loader(flow), len(flow)))


def test_staging_leaves_the_loaders_arrays_as_they_were():
    items = _items((5, 7, 2))
    batches = list(_loader(items))
    kept = [c.copy() for c, _, _ in batches]

    class Replay:
        dataset = _loader(items).dataset

        def __iter__(self):
            return iter(batches)

    _evaluator(4).extract_features(Replay())
    assert all(np.array_equal(c, k) for (c, _, _), k in zip(batches, kept))
