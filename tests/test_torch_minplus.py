"""The port's min-plus op against grl_tpu's Pallas kernel (interpret mode)."""

import numpy as np
import pytest
import torch

from grl_tpu.ops import minplus_matmul
from grl_tpu_torch.ops import minplus, minplus_plain

CASES = {
    # the dense and the ragged (non-tile-multiple m, n, k) cases of test_ops.py
    "dense": lambda rng: (np.abs(rng.randn(37, 300)), np.abs(rng.randn(150, 300))),
    "ragged": lambda rng: (rng.rand(5, 17), rng.rand(9, 17)),
}


def _inputs(case):
    a, b = CASES[case](np.random.RandomState(0))
    return a.astype(np.float32), b.astype(np.float32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_kernel(case):
    a, b = _inputs(case)
    want = np.asarray(minplus_matmul(a, b, interpret=True))
    got = minplus_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk_elems", [1, 300, 5000])
def test_plain_chunking_is_exact(chunk_elems):
    a, b = (torch.from_numpy(x) for x in _inputs("dense"))
    whole = torch.minimum(a[:, None, :], b[None, :, :]).sum(-1)
    torch.testing.assert_close(minplus_plain(a, b, chunk_elems=chunk_elems), whole, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    a, b = (torch.from_numpy(x) for x in _inputs("ragged"))
    before = minplus.launches
    out = minplus(a, b)
    assert minplus.launches == before
    torch.testing.assert_close(out, minplus_plain(a, b), rtol=0, atol=0)


def test_wrapper_rejects_bad_operands():
    a = torch.rand(4, 8)
    with pytest.raises(ValueError):
        minplus(a, torch.rand(5, 7))
    with pytest.raises(TypeError):
        minplus(a.double(), torch.rand(5, 8).double())
    with pytest.raises(ValueError):
        minplus(a[0], torch.rand(5, 8))
