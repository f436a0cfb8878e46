"""The port's staged, capacity-padded and host re-ranking builders against
grl_tpu's.

The references are grl_tpu's ``re_ranking_device(staged=True | valid=...)``
(the port's ``re_ranking`` with its cut ``ONE_PROGRAM_MAX`` shrunk, or
``valid``) and ``re_ranking_device_padded`` with the Pallas min-plus kernel
interpreted (as its own tests run them on the CPU), and its host numpy
``re_ranking``. Module constants that shrink the slabs and row blocks are
set alike on both sides, as ``tests/test_metrics.py`` shrinks grl_tpu's.
Inputs are made from a seed with numpy. Tolerance 1e-5 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu.engine import rerank as J
from grl_tpu_torch.engine import rerank as T
from test_torch_rerank import _duplicated_layout

TOL = 1e-5


def _dists(nq, ng, seed, zero_diag=False):
    rng = np.random.RandomState(seed)
    feats = rng.randn(nq + ng, 8).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    d = np.sqrt(np.maximum(2 - 2 * (feats @ feats.T), 1e-12)).astype(np.float32)
    if zero_diag:
        np.fill_diagonal(d, 0.0)
    return d[:nq, nq:], d[:nq, :nq], d[nq:, nq:]


def _pad_garbage(rng, m, rows, cols):
    """``m`` in the top-left corner of a (rows, cols) matrix of adversarial
    garbage (huge, negative, tiny, zero)."""
    out = rng.choice(np.array([1e6, -5.0, 3e-8, 0.0], np.float32), size=(rows, cols))
    out[: m.shape[0], : m.shape[1]] = m
    return out


def _port(fn, mats, *args, **kw):
    return fn(*(torch.from_numpy(np.ascontiguousarray(m)) for m in mats), *args, **kw).numpy()


def _jax(fn, mats, *args, **kw):
    return np.asarray(fn(*(jnp.asarray(m) for m in mats), *args, interpret=True, **kw))


@pytest.fixture
def blocks(monkeypatch):
    """Set the min-plus slab and stage block widths on both sides; grl_tpu's
    stage programs close over the block width, so its cache is cleared."""
    def set_widths(chunk=8192, block=4096):
        for mod in (J, T):
            monkeypatch.setattr(mod, "_MINPLUS_CHUNK", chunk)
            monkeypatch.setattr(mod, "_STAGE_BLOCK", block)
        J._STAGED_CACHE.clear()

    yield set_widths
    J._STAGED_CACHE.clear()


@pytest.fixture
def staged(monkeypatch):
    """The port's ``re_ranking`` on the staged builder at every n (its cut
    shrunk to 0), as grl_tpu's ``staged=True``."""
    monkeypatch.setattr(T, "ONE_PROGRAM_MAX", 0)


@pytest.mark.parametrize("chunk", [8192, 16, 8])
@pytest.mark.parametrize("k2", [1, 3])
def test_staged_min_plus_slabs_match_grl_tpu(blocks, staged, chunk, k2):
    """The deferred-slab loop: one slab (8192), slabs wider than the 10
    queries (16: the query rows come out of slab 0) and narrower (8: they
    are expanded on their own); k2 = 1 has no query expansion."""
    blocks(chunk=chunk)
    mats = _dists(10, 40, seed=3)
    want = _jax(J.re_ranking_device, mats, k1=5, k2=k2, staged=True)
    got = _port(T.re_ranking, mats, k1=5, k2=k2)
    assert got.shape == want.shape == (10, 40)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("nq,ng", [(23, 82), (8, 40)], ids=["n105_ragged", "g40_ragged"])
def test_staged_row_blocks_match_grl_tpu(blocks, staged, nq, ng):
    """16-row stage blocks at n = 105 and G = 40: ragged last blocks here,
    grl_tpu's overlapping tails there."""
    blocks(block=16)
    mats = _dists(nq, ng, seed=7)
    want = _jax(J.re_ranking_device, mats, staged=True)
    np.testing.assert_allclose(_port(T.re_ranking, mats), want, rtol=0, atol=TOL)
    # the staged V and the one-program V are the same matrix
    box = [torch.from_numpy(m) for m in mats]
    v, original_q, _ = T._build_v_staged(box)
    assert box == []  # emptied on entry
    original = np.block([[mats[1], mats[0]], [mats[0].T, mats[2]]]) ** 2
    original = (original / original.max(0)).T.astype(np.float32)
    np.testing.assert_allclose(v.numpy(), T.v_from_original(torch.from_numpy(original), 20, 6).numpy(),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(original_q.numpy(), original[:nq], rtol=1e-6, atol=0)


# (nq, ng, Q, G), k2: both axes padded, query axis full, gallery axis full,
# no query expansion, and G = 40 (ragged 16-row blocks over the padding)
GEOMETRIES = [((6, 30, 8, 48), 3), ((8, 30, 8, 48), 3), ((6, 48, 8, 48), 3), ((6, 30, 8, 48), 1),
              ((6, 34, 8, 40), 3)]


@pytest.mark.parametrize("geometry,k2", GEOMETRIES, ids=["both", "q_full", "g_full", "k2_1", "g40"])
def test_padded_builders_match_grl_tpu_and_host(blocks, geometry, k2):
    """re_ranking_padded and the masked staged builder (``valid``) on
    garbage-padded inputs: equal to grl_tpu's counterparts, and on the
    valid slices to the host form of the unpadded inputs."""
    blocks(block=16)
    nq, ng, Q, G = geometry
    mats = _dists(nq, ng, seed=13, zero_diag=True)
    rng = np.random.RandomState(0)
    padded = [_pad_garbage(rng, m, r, c) for m, (r, c) in zip(mats, [(Q, G), (Q, Q), (G, G)])]
    host = T.re_ranking_host(*mats, k1=5, k2=k2)
    one = _port(T.re_ranking_padded, padded, nq, ng, k1=5, k2=k2)[:nq, :ng]
    staged = _port(T.re_ranking, padded, k1=5, k2=k2, valid=(nq, ng))[:nq, :ng]
    np.testing.assert_allclose(one, _jax(J.re_ranking_device_padded, padded, nq, ng, k1=5, k2=k2)[:nq, :ng],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(staged, _jax(J.re_ranking_device, padded, k1=5, k2=k2, valid=(nq, ng))[:nq, :ng],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(one, host, rtol=0, atol=TOL)
    np.testing.assert_allclose(staged, host, rtol=0, atol=TOL)


@pytest.mark.parametrize("route", ["one_program", "padded", "staged"])
def test_k1_40_on_every_route_matches_grl_tpu(monkeypatch, route):
    """k1 = 40: each row's 41 nearest columns, past one 32-column round of
    the selection kernel, on each builder, against grl_tpu's."""
    mats = _dists(25, 90, seed=21, zero_diag=True)
    if route == "padded":
        rng = np.random.RandomState(1)
        padded = [_pad_garbage(rng, m, r, c) for m, (r, c) in zip(mats, [(28, 100), (28, 28), (100, 100)])]
        got = _port(T.re_ranking_padded, padded, 25, 90, k1=40, k2=6)[:25, :90]
        want = _jax(J.re_ranking_device_padded, padded, 25, 90, k1=40, k2=6)[:25, :90]
    else:
        if route == "staged":
            monkeypatch.setattr(T, "ONE_PROGRAM_MAX", 0)
        got = _port(T.re_ranking, mats, k1=40, k2=6)
        want = _jax(J.re_ranking_device, mats, k1=40, k2=6, staged=route == "staged")
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("builder", ["padded", "staged"])
def test_index_growth_through_one_padded_shape(builder):
    """The serve daemon's index grows inside one buffer: successive valid
    counts in the same padded matrices each equal the host form."""
    rng = np.random.RandomState(1)
    mats = _dists(8, 48, seed=17, zero_diag=True)
    for nq, ng in [(5, 20), (7, 40), (8, 48)]:
        valid = [mats[0][:nq, :ng], mats[1][:nq, :nq], mats[2][:ng, :ng]]
        want = T.re_ranking_host(*valid, k1=5, k2=3)
        padded = [_pad_garbage(rng, m, r, c) for m, (r, c) in zip(valid, [(8, 48), (8, 8), (48, 48)])]
        if builder == "padded":
            got = _port(T.re_ranking_padded, padded, nq, ng, k1=5, k2=3)
        else:
            got = _port(T.re_ranking, padded, k1=5, k2=3, valid=(nq, ng))
        np.testing.assert_allclose(got[:nq, :ng], want, rtol=0, atol=TOL)


@pytest.mark.parametrize("layout", [(25, 90, 0), (4, 9, 1), (40, 60, 2)])
def test_host_form_is_grl_tpu_host_bit_for_bit(layout):
    mats = _dists(*layout)
    np.testing.assert_array_equal(T.re_ranking_host(*mats), J.re_ranking(*mats))
    np.testing.assert_array_equal(T.re_ranking_host(*mats, k1=5, k2=1, lambda_value=0.5),
                                  J.re_ranking(*mats, k1=5, k2=1, lambda_value=0.5))


@pytest.mark.parametrize("builder", ["staged", "padded", "staged_masked"])
def test_lattice_ties_match_grl_tpu_device_path(blocks, monkeypatch, builder):
    """The lattice layout (most rows tie across the k1 + 1, ⌊k1/2⌋ + 1 and
    k2 boundaries) through the staged and padded builders: ties go to the
    lower index, as ``lax.top_k``'s do."""
    blocks(chunk=64, block=48)
    mats = _duplicated_layout()[:3]
    if builder == "staged":
        monkeypatch.setattr(T, "ONE_PROGRAM_MAX", 0)
        want = _jax(J.re_ranking_device, mats, staged=True)
        got = _port(T.re_ranking, mats)
    else:
        # pads at the end of each axis: the valid items keep their indices
        q, g = mats[0].shape
        padded = [_pad_garbage(np.random.RandomState(5), m, r, c)
                  for m, (r, c) in zip(mats, [(q + 8, g + 24), (q + 8, q + 8), (g + 24, g + 24)])]
        if builder == "padded":
            want = _jax(J.re_ranking_device_padded, padded, q, g)[:q, :g]
            got = _port(T.re_ranking_padded, padded, q, g)[:q, :g]
        else:
            want = _jax(J.re_ranking_device, padded, valid=(q, g))[:q, :g]
            got = _port(T.re_ranking, padded, valid=(q, g))[:q, :g]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_builder_choice_and_box_hand_over(monkeypatch):
    """The one-program path up to ``ONE_PROGRAM_MAX`` items, the staged
    builder past it (the cut shrunk to n - 1) or under ``valid``, and
    ``inputs_box`` emptied on entry."""
    calls = []
    build = T._build_v_staged
    monkeypatch.setattr(T, "_build_v_staged", lambda *a, **k: calls.append(k) or build(*a, **k))
    mats = [torch.from_numpy(m) for m in _dists(10, 40, seed=3)]
    box = list(mats)
    auto = T.re_ranking(inputs_box=box, k1=5, k2=3)
    assert box == [] and calls == []
    masked = T.re_ranking(*mats, k1=5, k2=3, valid=(10, 40))
    assert len(calls) == 1 and calls[0]["valid"] == (10, 40)
    torch.testing.assert_close(masked, auto, rtol=0, atol=TOL)
    monkeypatch.setattr(T, "ONE_PROGRAM_MAX", 50)
    T.re_ranking(*mats, k1=5, k2=3)
    assert len(calls) == 1  # n = 50 is at the cut
    monkeypatch.setattr(T, "ONE_PROGRAM_MAX", 49)
    torch.testing.assert_close(T.re_ranking(*mats, k1=5, k2=3), auto, rtol=0, atol=TOL)
    assert len(calls) == 2 and calls[1]["valid"] is None


def test_evaluator_hands_the_distances_over_in_a_box(monkeypatch):
    """Evaluator.evaluate passes [q_g, q_q, g_g] through ``inputs_box`` (so
    the staged builder can free them) and keeps no reference of its own."""
    import argparse

    from grl_tpu_torch.cli.train import build_models
    from grl_tpu_torch.data import ClipDataset, ClipLoader, SyntheticVideoReID
    from grl_tpu_torch.engine import Evaluator
    from grl_tpu_torch.engine import evaluator as E

    seen = {}
    real = E.re_ranking

    def spy(*args, inputs_box=None, **kw):
        seen["args"], seen["box"] = args, list(inputs_box)
        return real(inputs_box=inputs_box, **kw)

    monkeypatch.setattr(E, "re_ranking", spy)
    cnn, sia, _ = build_models(argparse.Namespace(arch2="siamese", seed=0), tiny=True)
    ds = SyntheticVideoReID(seed=0)
    loader = lambda items: ClipLoader(ClipDataset(items, 2, "dense", 64, 32), batch_size=1)
    res = Evaluator(cnn, sia, micro_batch=4, rerank=True, device="cpu").evaluate(loader(ds.query),
                                                                                 loader(ds.gallery))
    assert seen["args"] == () and len(seen["box"]) == 3
    q, g = res.qf.shape[0], res.gf.shape[0]
    assert [tuple(m.shape) for m in seen["box"]] == [(q, g), (q, q), (g, g)]
