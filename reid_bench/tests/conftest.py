"""Small sizes of the benchmark's cells for the CPU, and the card's fixture.

Run with ``python -m pytest -q reid_bench/tests``; the tests marked
``cuda`` run on a card (``python -m pytest -q -m cuda reid_bench/tests``)
and skip without one.
"""

from __future__ import annotations

import pytest
import torch

# every configuration's widths cut to the CLIs' --tiny model, frames to 64x32
TINY_CONFIG = dict(trunk_layers=[1, 1, 1, 1], trunk_width=4, feat_dim=128, siamese_out=16, seq_len=4, height=64,
                   width=32, train_batch=8, num_train_ids=6, num_train_tracklets=30, gallery_size=60,
                   num_test_ids=10)
TINY_PARAMS = {
    "dense_index": dict(micro_batch=6, chunk_tracklets=5, length_mean=12, length_min=2, length_max=24, pool_frames=200,
                        pool_segment=16, calibration_clips=4, sample=3, workers=2, trace_seconds=1),
    "pair_train": dict(chunk_steps=2, length_min=2, length_max=24, pool_frames=200, pool_segment=16, workers=2,
                       trace_seconds=1),
    "rerank_open_loop": dict(export_batch=4, model_flags=["--tiny"], q_max=4, connections=2, rate=4.0, sample=2,
                             warm_requests=1, trace_seconds=1),
}


def tiny(kind):
    return {"config": dict(TINY_CONFIG), "params": dict(TINY_PARAMS[kind])}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
