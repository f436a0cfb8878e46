"""The port's re-ranking and protocol against grl_tpu's device path.

The reference is ``re_ranking_device(..., interpret=True)``: the one-program
path a TPU runs, with its ``lax.top_k`` tie order. (grl_tpu's host numpy
``re_ranking`` sorts with an unstable argsort, so its tie order is not the
device path's.) Tolerance 1e-4, as in test_ops.py.
"""

import numpy as np
import pytest
import torch

from grl_tpu.engine import metrics as jmetrics
from grl_tpu.engine.evaluator import _euclidean as j_euclidean
from grl_tpu.engine.evaluator import cosine_distance as j_cosine
from grl_tpu.engine.rerank import re_ranking_device
from grl_tpu_torch.engine import metrics as tmetrics
from grl_tpu_torch.engine.evaluator import _euclidean, cosine_distance
from grl_tpu.engine.rerank import _v_from_original as j_v_from_original
from grl_tpu_torch.engine import rerank as R
from grl_tpu_torch.engine.rerank import re_ranking, v_from_original, warn_if_degenerate
from grl_tpu_torch.ops import nearest_k, nearest_plain
from grl_tpu_torch.ops.minplus import aligned
from grl_tpu_torch.ops.nearest import MAX_COLUMNS
from torch_oracle import dense_expansion


def _synthetic_dists(q, g, dim=32, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(q + g, dim).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    d = np.linalg.norm(feats[:, None] - feats[None, :], axis=2)
    return d[:q, q:], d[:q, :q], d[q:, q:]


def _duplicated_layout(q=40, g=120, dim=4, seed=0):
    """The evaluator's inputs: gallery = query ∪ gallery, so every query
    appears twice; q_g cosine, q_q and g_g euclidean. Features on a small
    lattice ({-1, 0, 1}^dim, normalized) make many distances exactly equal,
    so most rows tie across the k1 + 1, ⌊k1/2⌋ + 1 and k2 boundaries."""
    rng = np.random.RandomState(seed)
    feats = rng.randint(-1, 2, (q + g, dim)).astype(np.float32)
    feats[np.abs(feats).sum(1) == 0, 0] = 1.0
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    qf, gf = feats[:q], np.concatenate([feats[:q], feats[q:]])
    return (np.asarray(j_cosine(qf, gf)), np.asarray(j_euclidean(qf, qf)),
            np.asarray(j_euclidean(gf, gf)), qf, gf)


LAYOUTS = {
    "synthetic_25x90": lambda: _synthetic_dists(25, 90),
    "tiny_gallery_clamps_topk": lambda: _synthetic_dists(4, 9),  # n = 13 < k1 + 1
    "duplicated_query_in_gallery": lambda: _duplicated_layout()[:3],
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_rerank_matches_device_path(layout):
    qg, qq, gg = LAYOUTS[layout]()
    want = np.asarray(re_ranking_device(qg, qq, gg, interpret=True))
    got = re_ranking(*(torch.tensor(np.asarray(x)) for x in (qg, qq, gg)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_duplicated_layout_has_topk_ties():
    """The duplicated layout must actually exercise tie-breaking across the
    k1 + 1 boundary, or the test above proves nothing about it."""
    qg, qq, gg = (torch.tensor(x) for x in _duplicated_layout()[:3])
    original = torch.cat([torch.cat([qq, qg], 1), torch.cat([qg.T, gg], 1)]).square()
    original = (original / original.max(dim=0).values).T
    srt = original.sort(dim=1).values
    assert int((srt[:, 20] == srt[:, 21]).sum()) > 100  # of 200 rows


def test_nearest_breaks_ties_to_lower_index():
    row = torch.tensor([[0.5, 0.1, 0.3, 0.1, 0.3, 0.2, 0.1]])
    assert nearest_plain(row, 3)[0].tolist() == [1, 3, 6]


def test_distances_match_grl_tpu():
    rng = np.random.RandomState(1)
    qf, gf = (rng.randn(n, 64).astype(np.float32) for n in (30, 90))
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    gf /= np.linalg.norm(gf, axis=1, keepdims=True)
    tq, tg = torch.from_numpy(qf), torch.from_numpy(gf)
    np.testing.assert_allclose(cosine_distance(tq, tg).numpy(), np.asarray(j_cosine(qf, gf)),
                               rtol=1e-5, atol=1e-6)
    # off the diagonal; on it |a|² − 2a·a + |a|² is fp32 cancellation noise
    # (~1e-7) whose square root (~3e-4) differs between any two matmuls
    got, want = _euclidean(tg, tg).numpy(), np.asarray(j_euclidean(gf, gf))
    off = ~np.eye(len(gf), dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=1e-5, atol=1e-5)
    assert np.all(np.diag(got) < 1e-3)


def _tie_heavy_protocol(seed=3, q=20, g=70):
    rng = np.random.RandomState(seed)
    distmat = rng.randint(0, 4, (q, g)).astype(np.float32)  # exact ties everywhere
    return (distmat, rng.randint(0, 8, q), rng.randint(0, 8, g),
            rng.randint(0, 3, q), rng.randint(0, 3, g))


@pytest.mark.parametrize("max_rank", [20, 100])
def test_protocol_matches_grl_tpu_on_ties(max_rank):
    args = _tie_heavy_protocol()
    cmc_ref, map_ref = jmetrics.evaluate(*args, max_rank=max_rank)
    cmc_host, map_host = tmetrics.evaluate(*args, max_rank=max_rank)
    cmc_dev, map_dev = tmetrics.evaluate_device(torch.from_numpy(args[0]), *args[1:],
                                                max_rank=max_rank)
    np.testing.assert_array_equal(cmc_host, cmc_ref)
    np.testing.assert_array_equal(cmc_dev, cmc_ref)
    assert abs(map_host - map_ref) < 1e-6
    assert abs(map_dev - map_ref) < 1e-6


@pytest.mark.parametrize("fn", ["evaluate", "evaluate_device"])
def test_protocol_raises_when_no_valid_query(fn):
    distmat = np.random.RandomState(0).rand(3, 4).astype(np.float32)
    args = (np.array([1, 2, 3]), np.array([7, 8, 9, 7]), np.zeros(3, np.int32), np.ones(4, np.int32))
    with pytest.raises(RuntimeError):
        getattr(tmetrics, fn)(torch.from_numpy(distmat) if fn == "evaluate_device" else distmat, *args)


def test_degenerate_scale_warning(capsys):
    assert warn_if_degenerate(13, k1=20)
    assert "WARNING" in capsys.readouterr().err
    assert not warn_if_degenerate(11310, k1=20)
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("k2", [1, 6])
def test_v_is_built_in_16_byte_rows_and_matches_grl_tpu(k2):
    """V comes in rows padded to 4 floats, so the kernel reads V and its
    query rows in place, with grl_tpu's values."""
    qg, qq, gg = _synthetic_dists(25, 90)
    original = np.concatenate([np.concatenate([qq, qg], 1), np.concatenate([qg.T, gg], 1)]) ** 2
    original = (original / original.max(0)).T.astype(np.float32)
    v = v_from_original(torch.from_numpy(original.copy()), 20, k2)
    n = original.shape[0]
    assert v.shape == (n, n) and v.stride() == (-(-n // 4) * 4, 1) and n % 4 != 0
    query_rows = v[:25]
    assert aligned(v) is v and aligned(query_rows) is query_rows
    want = np.asarray(j_v_from_original(original, 20, k2))
    np.testing.assert_allclose(v.numpy(), want, rtol=1e-5, atol=1e-6)


def _lists(mats, k1, start=0, rows=None, dtype=torch.int64):
    """The nearest lists of the joined, normalized distances, as
    ``v_from_original`` hands them to ``_expansion_rows`` (the sharded
    builder: int32, with its row range)."""
    qg, qq, gg = mats
    original = np.block([[qq, qg], [qg.T, gg]]) ** 2
    order = nearest_plain(torch.from_numpy((original / original.max(0)).T.astype(np.float32)), k1 + 1).to(dtype)
    half = int(np.around(k1 / 2.0)) + 1
    return [((order[:, : k1 + 1], order[:, :half], start, rows), {})]


def _routed(run):
    """Every call that a route makes to ``_expansion_rows``, its arguments
    as given (the route's own clamps, pads and row ranges)."""
    def lists(monkeypatch):
        calls, real = [], R._expansion_rows
        with monkeypatch.context() as m:
            m.setattr(R, "_expansion_rows", lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw))
            run()
        assert calls
        return calls
    return lists


def _padded_inputs(nq=20, ng=70, Q=24, G=90):
    """The duplicated layout in capacity-padded buffers of garbage."""
    rng = np.random.RandomState(4)
    mats = _duplicated_layout(q=nq, g=ng - nq, seed=2)[:3]
    pads = [rng.choice(np.array([1e6, -5.0, 3e-8, 0.0], np.float32), size=shape) for shape in [(Q, G), (Q, Q), (G, G)]]
    for pad, m in zip(pads, mats):
        pad[: m.shape[0], : m.shape[1]] = m
    return [torch.from_numpy(p) for p in pads]


EXPANSION_CASES = {
    "random_k1_20": lambda mp: _lists(_synthetic_dists(25, 90), 20),
    "random_seed5_k1_7": lambda mp: _lists(_synthetic_dists(30, 120, seed=5), 7),
    "duplicated_ties_k1_20": lambda mp: _lists(_duplicated_layout()[:3], 20),
    "duplicated_ties_k1_5": lambda mp: _lists(_duplicated_layout(seed=1)[:3], 5),
    "n_at_k1_plus_1": lambda mp: _lists(_synthetic_dists(4, 17), 20),
    "n_below_k1_plus_1": lambda mp: _lists(_synthetic_dists(4, 9), 20),
    "row_range_int32": lambda mp: _lists(_synthetic_dists(25, 90), 20, start=37, rows=50, dtype=torch.int32),
    "padded_route": _routed(lambda: R.re_ranking_padded(*_padded_inputs(), 20, 70)),
    "masked_staged_route": _routed(lambda: R.re_ranking(*_padded_inputs(), valid=(20, 70))),
}


def _row_range(idx_k1, idx_half, start=0, rows=None):
    return start, idx_k1.shape[0] - start if rows is None else rows


@pytest.mark.parametrize("case", sorted(EXPANSION_CASES))
def test_expansion_from_lists_equals_dense_products(monkeypatch, case):
    """The expansion built from the neighbour lists is the dense 0/1
    products' bit for bit, on every row range a route asks for."""
    for args, kw in EXPANSION_CASES[case](monkeypatch):
        got = R._expansion_rows(*args, **kw)
        start, rows = _row_range(*args, **kw)
        assert got.dtype == torch.bool and got.shape == (rows, args[0].shape[0])
        assert torch.equal(got, dense_expansion(args[0], args[1])[start : start + rows])


def _joined(mats):
    """The joined, normalized distances that ``v_from_original`` selects from."""
    qg, qq, gg = mats
    original = np.block([[qq, qg], [qg.T, gg]]) ** 2
    return torch.from_numpy(np.ascontiguousarray((original / original.max(0)).T, dtype=np.float32))


def _padded_original(valid=90):
    """``re_ranking_padded``'s geometry: rows and columns past the valid
    items at 2.0, every diagonal entry 0."""
    x = _joined(_synthetic_dists(25, 90))
    x[valid:], x[:, valid:] = 2.0, 2.0
    return x.fill_diagonal_(0.0)


SELECTIONS = {
    "random_k1": (lambda: _joined(_synthetic_dists(25, 90)), 1),
    "random_k21": (lambda: _joined(_synthetic_dists(25, 90)), 21),
    "random_k32": (lambda: _joined(_synthetic_dists(30, 120, seed=5)), 32),
    "random_k41": (lambda: _joined(_synthetic_dists(30, 120, seed=5)), 41),
    "random_every_column": (lambda: _joined(_synthetic_dists(25, 90)), 115),
    "duplicated_ties_k6": (lambda: _joined(_duplicated_layout()[:3]), 6),
    "duplicated_ties_k11": (lambda: _joined(_duplicated_layout()[:3]), 11),
    "duplicated_ties_k21": (lambda: _joined(_duplicated_layout()[:3]), 21),
    "padded_rows_k21": (_padded_original, 21),
    "n_below_k_clamps": (lambda: _joined(_synthetic_dists(4, 9)), 21),
    "row_strided_view": (lambda: _joined(_synthetic_dists(25, 90))[3:, :60], 21),
    "all_tied": (lambda: torch.zeros(7, 30), 21),
}


@pytest.mark.parametrize("case", sorted(SELECTIONS))
def test_nearest_selection_is_the_stable_orders_prefix_and_launches_nothing_on_the_cpu(case):
    """``nearest_plain`` and the wrapper give the stable ascending order's
    first k columns (clamped to n), ties to the lower index; a CPU tensor
    takes the plain version and launches no kernel."""
    x, k = SELECTIONS[case][0](), SELECTIONS[case][1]
    want = torch.argsort(x, dim=1, stable=True)[:, :k]
    before = nearest_k.launches
    for fn in (nearest_plain, nearest_k):
        got = fn(x, k)
        assert got.dtype == torch.int64 and got.shape == (x.shape[0], min(k, x.shape[1]))
        assert torch.equal(got, want)
    assert nearest_k.launches == before


REFUSALS = {
    "negative_k": (lambda: torch.rand(4, 64), -1, ValueError),
    "n_above_max_columns": (lambda: torch.zeros(2, MAX_COLUMNS + 1), 21, ValueError),
    "float64": (lambda: torch.rand(4, 64, dtype=torch.float64), 21, TypeError),
    "bfloat16": (lambda: torch.rand(4, 64).bfloat16(), 21, TypeError),
    "column_strided": (lambda: torch.rand(4, 128)[:, ::2], 21, ValueError),
    "transposed": (lambda: torch.rand(64, 4).T, 21, ValueError),
    "one_dimensional": (lambda: torch.rand(64), 21, ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_nearest_k_refuses_what_the_kernel_does_not_take(case):
    make, k, error = REFUSALS[case]
    with pytest.raises(error):
        nearest_k(make(), k)


def test_every_one_program_row_fits_the_selection_kernel():
    """The one-program and padded builders select from rows of at most
    ``ONE_PROGRAM_MAX`` columns; the kernel takes them at any k."""
    assert R.ONE_PROGRAM_MAX <= MAX_COLUMNS
    assert nearest_k(torch.rand(3, MAX_COLUMNS), 41).shape == (3, 41)
