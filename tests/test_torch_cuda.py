"""The port's hand-written kernels on a CUDA card, against their plain versions.

This file imports torch and grl_tpu_torch only, so it also runs on a
machine without JAX; ``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips without a card.
"""

import pytest
import torch

from grl_tpu_torch.engine.evaluator import _euclidean, cosine_distance
from grl_tpu_torch.engine.rerank import re_ranking
from grl_tpu_torch.ops import minplus, minplus_plain

pytestmark = pytest.mark.cuda

# fp32 sums of row-normalized values (each ≤ 1) taken in another order
TOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("the hand-written CUDA kernels run only on a card")
    return torch.Generator(device="cuda").manual_seed(0)


def row_normalized(rows, k, gen):
    x = torch.rand(rows, k, device="cuda", generator=gen)
    return x / x.sum(dim=1, keepdim=True)


@pytest.mark.parametrize("shape", [(37, 150, 300), (5, 9, 17), (129, 257, 1000), (128, 256, 64)])
def test_minplus_kernel_matches_plain(gen, shape):
    m, n, k = shape
    a, b = row_normalized(m, k, gen), row_normalized(n, k, gen)
    before = minplus.launches
    out = minplus(a, b)
    torch.cuda.synchronize()
    assert minplus.launches == before + 1
    torch.testing.assert_close(out, minplus_plain(a, b), rtol=0, atol=TOL)


def test_minplus_rejects_what_the_kernel_does_not_take(gen):
    a, b = row_normalized(8, 16, gen), row_normalized(6, 16, gen)
    with pytest.raises(ValueError):
        minplus(a.T.contiguous().T, b)  # not contiguous
    with pytest.raises(ValueError):
        minplus(a, b.cpu())


def test_rerank_on_card_matches_plain_min_sum(gen):
    feats = torch.randn(120, 64, device="cuda", generator=gen)
    feats = feats / feats.norm(dim=1, keepdim=True)
    qf, gf = feats[:30], feats  # gallery = query ∪ gallery
    dists = cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf)
    before = minplus.launches
    got = re_ranking(*dists)
    torch.cuda.synchronize()
    assert minplus.launches == before + 1
    want = re_ranking(*dists, min_sum_fn=minplus_plain)
    assert got.shape == (30, 120)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)
