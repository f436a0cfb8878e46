"""The port's retrieval metrics (``engine/metrics.py``: ``cmc`` with every
option, ``mean_ap``, ``accuracy``, ``evaluate_market``) against grl_tpu's
on seeded distance matrices, tie-heavy ones included.
"""

import numpy as np
import pytest
import torch

from grl_tpu.engine import metrics as J
from grl_tpu_torch.engine import metrics as T


def case(seed, ties):
    """A (12, 40) distance matrix over 6 ids and 3 cameras, pid -1 junk
    in the gallery; ``ties`` rounds the distances to 10 levels."""
    rng = np.random.RandomState(seed)
    distmat = rng.rand(12, 40)
    if ties:
        distmat = np.round(distmat, 1)
    q_pids, g_pids = rng.randint(0, 6, 12), rng.randint(0, 6, 40)
    g_pids[:3] = -1
    return distmat, q_pids, g_pids, rng.randint(0, 3, 12), rng.randint(0, 3, 40)


CASES = [(seed, ties) for seed in (0, 1) for ties in (False, True)]
IDS = [f"seed{s}-{'ties' if t else 'distinct'}" for s, t in CASES]


@pytest.mark.parametrize("seed,ties", CASES, ids=IDS)
@pytest.mark.parametrize("options", [
    {}, {"separate_camera_set": True}, {"single_gallery_shot": True, "seed": 3},
    {"first_match_break": True}, {"single_gallery_shot": True, "first_match_break": True, "seed": 4},
    {"topk": 5}], ids=["allshots", "separate", "single_shot", "first_match", "cuhk03", "topk5"])
def test_cmc_equals_grl_tpu(seed, ties, options):
    distmat, q, g, qc, gc = case(seed, ties)
    got = T.cmc(distmat, q, g, qc, gc, **options)
    np.testing.assert_array_equal(got, J.cmc(distmat, q, g, qc, gc, **options))
    assert got.shape == (options.get("topk", 100),)


def test_cmc_and_mean_ap_default_ids_equal_grl_tpu():
    distmat = np.round(np.random.RandomState(5).rand(8, 8), 1)
    np.testing.assert_array_equal(T.cmc(distmat), J.cmc(distmat))
    assert T.mean_ap(distmat) == J.mean_ap(distmat)


@pytest.mark.parametrize("seed,ties", CASES, ids=IDS)
def test_mean_ap_and_market_equal_grl_tpu(seed, ties):
    distmat, q, g, qc, gc = case(seed, ties)
    assert T.mean_ap(distmat, q, g, qc, gc) == J.mean_ap(distmat, q, g, qc, gc)
    for max_rank in (100, 10):
        got, want = T.evaluate_market(distmat, q, g, qc, gc, max_rank), J.evaluate_market(distmat, q, g, qc, gc,
                                                                                             max_rank)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_no_valid_query_raises_as_grl_tpu():
    distmat = np.zeros((2, 3))
    ids = dict(query_ids=[0, 1], gallery_ids=[2, 3, 4])
    for fn in (T.cmc, T.mean_ap):
        with pytest.raises(RuntimeError, match="No valid query"):
            fn(distmat, **ids)
    with pytest.raises(RuntimeError, match="No valid query"):
        T.evaluate_market(distmat, [0, 1], [2, 3, 4], [0, 0], [1, 1, 1])


def test_accuracy_equals_grl_tpu():
    rng = np.random.RandomState(6)
    logits, target = rng.randn(50, 7), rng.randint(0, 7, 50)
    assert T.accuracy(logits, target, topk=(1, 3, 5)) == J.accuracy(logits, target, topk=(1, 3, 5))
