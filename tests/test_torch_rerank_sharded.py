"""The row-sharded re-ranking (``re_ranking(mesh=)``), the sharded protocol
(``evaluate_device(mesh=)``) and ``sharded_cosine_distance`` on 2 and 3
gloo ranks, against the port's one process and grl_tpu's mesh forms.

One ``parallel.launch`` per rank count runs every case
(``test_torch_parallel_worker.job_rerank_sharded``). The inputs are made
from a seed with numpy: n = 107 items (19 or 21 queries), which neither 2
nor 3 ranks divide, so the builder pads with phantom items; the slab and
row-block widths are shrunk (``_MINPLUS_CHUNK`` 8 or 16, ``_STAGE_BLOCK``
16 or 8) on both sides, as ``tests/test_torch_rerank_staged.py`` does, so
each rank runs several min-plus slabs and stage blocks. grl_tpu's
references run its mesh forms on a 2-device mesh of the 8-device virtual
CPU mesh (``tests/conftest.py``) with the Pallas kernel interpreted.

Tolerances, each beside its comparison:
- against the port's one process (the staged builder, and with ``valid=``
  the masked one): 1e-5 absolute, the kernel's tolerance on the card (the
  same sums in another order; read: ≤ 1.2e-7);
- against grl_tpu's ``re_ranking_device(..., mesh=data_mesh(2),
  interpret=True)``, one-program and staged: 1e-4, grl_tpu's own bound for
  its mesh forms (``tests/test_sharding.py``);
- the sharded protocol against one process: 1e-6 (CMC and mAP; only the
  order of the sums over ranks differs), on a catalog whose gallery holds
  junk pid -1 and whose query count leaves pad rows on both rank counts;
- the cosine blocks against the whole product: 1e-6.
"""

import os.path as osp
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

import test_torch_parallel_worker as W  # noqa: E402
from grl_tpu.engine import rerank as J  # noqa: E402
from grl_tpu.parallel import data_mesh  # noqa: E402
from grl_tpu_torch import parallel  # noqa: E402
from grl_tpu_torch.engine import metrics  # noqa: E402
from grl_tpu_torch.engine import rerank as T  # noqa: E402

TIMEOUT = 120  # seconds a launch may take before its ranks are killed
TOL, JAX_TOL = 1e-5, 1e-4


def _dists(nq, ng, seed):
    """A symmetric euclidean (nq + ng)² matrix of unit 8-d features."""
    rng = np.random.RandomState(seed)
    f = rng.randn(nq + ng, 8).astype(np.float32)
    f /= np.linalg.norm(f, axis=1, keepdims=True)
    return np.sqrt(np.maximum(2 - 2 * (f @ f.T), 1e-12)).astype(np.float32)


def _masked():
    """17 queries and 80 gallery items inside a (21 + 86)² capacity-padded
    matrix whose padding is adversarial garbage (huge, negative, tiny,
    zero), zero diagonal as the daemon's."""
    d = _dists(17, 80, 5)
    np.fill_diagonal(d, 0.0)
    rng = np.random.RandomState(0)
    c = rng.choice(np.array([1e6, -5.0, 3e-8, 0.0], np.float32), size=(107, 107))
    real = np.r_[0:17, 21:101]
    c[np.ix_(real, real)] = d
    return c


def _blocks(c, q):
    """(q_g, q_q, g_g) of the combined matrix c."""
    return c[:q, q:], c[:q, :q], c[q:, q:]


# (case, c, q, k1, k2, slab width, block width, valid)
CASES = [("k2_6", _dists(19, 88, 3), 19, 20, 6, 8, 16, None),
         ("k2_1", _dists(19, 88, 3), 19, 20, 1, 16, 8, None),
         ("valid", _masked(), 21, 20, 6, 8, 16, (17, 80))]


def _protocol_case():
    rng = np.random.RandomState(5)
    q, g = 23, 67  # pad rows on 2 ranks (12 + 11) and on 3 (8 + 8 + 7)
    distmat = rng.rand(q, g).astype(np.float32)
    g_pids = rng.randint(0, 6, g)
    g_pids[::5] = -1  # junk: a pad row's pid must never match it
    ids = (rng.randint(0, 6, q), g_pids, rng.randint(0, 3, q), rng.randint(0, 3, g))
    return distmat, ids


@pytest.fixture(scope="module")
def references():
    """Each case's one-process result (port) and grl_tpu's mesh forms."""
    out = {}
    saved = [(m, m._MINPLUS_CHUNK, m._STAGE_BLOCK) for m in (T, J)]
    cut, T.ONE_PROGRAM_MAX = T.ONE_PROGRAM_MAX, 0  # the port's staged builder at every n
    try:
        for name, c, q, k1, k2, chunk, block, valid in CASES:
            for m in (T, J):
                m._MINPLUS_CHUNK, m._STAGE_BLOCK = chunk, block
            J._STAGED_CACHE.clear()  # grl_tpu's stages close over the block width
            mats = _blocks(c, q)
            port = T.re_ranking(*(torch.from_numpy(np.ascontiguousarray(m)) for m in mats), k1=k1, k2=k2,
                                valid=valid).numpy()
            forms = [dict(staged=True, valid=valid)] + ([dict(staged=False)] if valid is None else [])
            jax = [np.asarray(J.re_ranking_device(*(jnp.asarray(m) for m in mats), k1=k1, k2=k2, interpret=True,
                                                  mesh=data_mesh(2), **kw)) for kw in forms]
            out[name] = port, jax
    finally:
        for m, chunk, block in saved:
            m._MINPLUS_CHUNK, m._STAGE_BLOCK = chunk, block
        T.ONE_PROGRAM_MAX = cut
        J._STAGED_CACHE.clear()
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["2_ranks", "3_ranks"])
def sharded(request, tmp_path_factory):
    """Every case on ``request.param`` gloo ranks: each rank's results."""
    rng = np.random.RandomState(9)
    payload = {"rerank": [dict(c=c, q=q, k1=k1, k2=k2, chunk=chunk, block=block, valid=valid)
                          for _, c, q, k1, k2, chunk, block, valid in CASES],
               "protocol": [_protocol_case()],
               "cosine": (rng.randn(13, 8).astype(np.float32), rng.randn(29, 8).astype(np.float32))}
    ranks = parallel.launch(W.job_rerank_sharded, payload, request.param, "cpu",
                            workdir=tmp_path_factory.mktemp("sharded"), timeout=TIMEOUT)
    return request.param, payload, ranks


def _valid_slice(x, valid):
    return x if valid is None else x[: valid[0], : valid[1]]


@pytest.mark.parametrize("case", range(len(CASES)), ids=[c[0] for c in CASES])
def test_sharded_builder_equals_one_process_and_grl_tpu(sharded, references, case):
    """Every rank's whole (q, g) result: within 1e-5 of the port's one
    process, within 1e-4 of each of grl_tpu's mesh forms (on the valid
    slice under ``valid``)."""
    _, _, ranks = sharded
    name, c, q, *_, valid = CASES[case]
    port, jax = references[name]
    for r in ranks:
        got = r["rerank"][case]["distmat"]
        assert got.shape == (q, c.shape[0] - q)
        np.testing.assert_allclose(_valid_slice(got, valid), _valid_slice(port, valid), rtol=0, atol=TOL)
        for want in jax:
            np.testing.assert_allclose(_valid_slice(got, valid), _valid_slice(want, valid), rtol=0, atol=JAX_TOL)


def test_no_rank_holds_an_n_by_n_matrix(sharded, monkeypatch):
    """No tensor that the sharded builder made on any rank spans n rows and
    n columns, and no matrix holds more elements than one rank's share of a
    stage buffer (per × n, rows padded to 16 bytes; the CPU's plain
    min-sum adds 3-d chunk temporaries of its own bounded size); the same
    spy on the one-process staged builder does see n × n buffers. The
    builder empties its input box, so the caller's block frees after s1."""
    size, _, ranks = sharded
    for case, (_, c, q, k1, k2, *_rest, valid) in enumerate(CASES):
        n0 = c.shape[0]
        per = -(-n0 // size)
        share = per * (-(-per * size // 4) * 4)
        for r in ranks:
            shapes = r["rerank"][case]["shapes"]
            assert not [s for s in shapes if len(s) == 2 and s[0] >= n0 and s[1] >= n0], shapes
            assert max(int(np.prod(s)) for s in shapes if len(s) == 2) <= share
            assert r["rerank"][case]["box_emptied"]
    monkeypatch.setattr(T, "ONE_PROGRAM_MAX", 0)  # the staged builder
    with W.ShapeSpy() as spy:
        T.re_ranking(*(torch.from_numpy(np.ascontiguousarray(m)) for m in _blocks(CASES[0][1], 19)))
    assert (107, 107) in spy.shapes


def test_sharded_protocol_equals_one_process(sharded):
    """``evaluate_device(mesh=)`` on each rank's query rows: the CMC curve
    and mAP of one process's ``evaluate_device`` within 1e-6, on every rank,
    with junk pid -1 in the gallery and pad rows on the ranks."""
    _, payload, ranks = sharded
    distmat, ids = payload["protocol"][0]
    want_cmc, want_map = metrics.evaluate_device(torch.from_numpy(distmat), *ids, max_rank=20)
    for r in ranks:
        cmc, mAP = r["protocol"][0]
        np.testing.assert_allclose(cmc, want_cmc, rtol=0, atol=1e-6)
        assert abs(mAP - want_map) <= 1e-6


def test_sharded_cosine_distance_blocks_make_the_whole_product(sharded):
    """The ranks' query-row blocks stacked, and their gallery-column blocks
    side by side, are ``-qf·gfᵀ``."""
    _, payload, ranks = sharded
    qf, gf = payload["cosine"]
    want = -(qf @ gf.T)
    np.testing.assert_allclose(np.concatenate([r["cosine"][0] for r in ranks]), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.concatenate([r["cosine"][1] for r in ranks], axis=1), want, rtol=0, atol=1e-6)
