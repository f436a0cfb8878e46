"""The port's dense evaluation with re-ranking, end to end, against grl_tpu.

uint8 clips -> 6144-d-recipe descriptor (at tiny widths) -> cosine and
euclidean distances -> k-reciprocal re-ranking -> CMC/mAP. The reference
chain is grl_tpu's descriptor, distances, ``re_ranking_device(interpret=
True)`` (the TPU path) and ``metrics.evaluate``; the port runs its own
``Evaluator`` over its own copies of the synthetic catalog and loader.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu import models as jm
from grl_tpu.data.catalogs.synthetic import SyntheticVideoReID as JSynthetic
from grl_tpu.data.loader import ClipDataset as JClipDataset
from grl_tpu.engine import metrics as jmetrics
from grl_tpu.engine.evaluator import _euclidean as j_euclidean
from grl_tpu.engine.evaluator import cosine_distance as j_cosine
from grl_tpu.engine.evaluator import make_descriptor_fn as j_descriptor_fn
from grl_tpu.engine.rerank import re_ranking_device
from grl_tpu_torch import models as tm
from grl_tpu_torch.data import ClipDataset, ClipLoader, SyntheticVideoReID
from grl_tpu_torch.engine import Evaluator, make_descriptor_fn
from grl_tpu_torch.ops import minplus
from grl_tpu_torch.utils import state_dict_from_jax
from test_torch_models import WIDTH, randomize_bn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, H, W = 3, 32, 16
CATALOG = dict(num_train_ids=0, num_test_ids=6, tracklets_per_id=2, num_cams=2,
               frames_range=(3, 8), height=H, width=W, seed=0)


@pytest.fixture(scope="module")
def model_pair():
    """grl_tpu GRL + Siamese at tiny widths (seeded BN stats), and the port's
    modules loaded from the same trees."""
    jcnn = jm.GRLModel(trunk=jm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))
    jsia = jm.Siamese(input_num=jcnn.num_feat, output_num=16)
    trees = {}
    for name, mod, seed in (("cnn", jcnn, 7), ("siamese", jsia, 8)):
        p, s = mod.init(jax.random.PRNGKey(seed))
        trees[name] = randomize_bn(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), seed)
    tcnn = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))
    tsia = tm.Siamese(input_num=tcnn.num_feat, output_num=16)
    for mod, (p, s) in ((tcnn, trees["cnn"]), (tsia, trees["siamese"])):
        mod.load_state_dict(state_dict_from_jax(p, s, mod), strict=True)
    describe = j_descriptor_fn(jcnn, jsia)
    j_describe = lambda clips: describe(*trees["cnn"], *trees["siamese"], jnp.asarray(clips))
    return j_describe, tcnn.eval(), tsia.eval()


def test_descriptor_matches_grl_tpu(model_pair):
    j_describe, tcnn, tsia = model_pair
    clips = np.random.RandomState(0).randint(0, 256, (2, T, H, W, 3)).astype(np.uint8)
    want = np.asarray(j_describe(clips))
    with torch.no_grad():
        got = make_descriptor_fn(tcnn, tsia)(torch.from_numpy(clips)).numpy()
    assert got.shape == want.shape == (2, 3 * tcnn.num_feat)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def _jax_features(j_describe, tracklets):
    """grl_tpu's dense extraction: every clip described, averaged per tracklet."""
    ds = JClipDataset(tracklets, seq_len=T, sample="dense", height=H, width=W)
    per = [ds.get(i)[0] for i in range(len(ds))]
    d = np.asarray(j_describe(np.concatenate(per)))
    bounds = np.cumsum([0] + [len(c) for c in per])
    return np.stack([d[a:b].mean(axis=0) for a, b in zip(bounds[:-1], bounds[1:])])


def test_dense_evaluation_with_rerank_matches_grl_tpu(model_pair):
    j_describe, tcnn, tsia = model_pair

    # reference chain: grl_tpu's catalog, loader sampling and device path
    jds = JSynthetic(**CATALOG)
    qf = _jax_features(j_describe, jds.query)
    gf = np.concatenate([qf, _jax_features(j_describe, jds.gallery)])
    q_pids, q_cams = np.array(jds.queryinfo.pid), np.array(jds.queryinfo.camid)
    g_pids = np.append(q_pids, jds.galleryinfo.pid)
    g_cams = np.append(q_cams, jds.galleryinfo.camid)
    want = np.asarray(re_ranking_device(
        np.asarray(j_cosine(qf, gf)), np.asarray(j_euclidean(qf, qf)),
        np.asarray(j_euclidean(gf, gf)), interpret=True))
    cmc_want, map_want = jmetrics.evaluate(want, q_pids, g_pids, q_cams, g_cams)

    # the port, through its own entry points
    ds = SyntheticVideoReID(**CATALOG)
    loader = lambda items: ClipLoader(ClipDataset(items, T, "dense", H, W), batch_size=1, workers=2)
    before = minplus.launches
    res = Evaluator(tcnn, tsia, micro_batch=4, rerank=True, device="cpu").evaluate(
        loader(ds.query), loader(ds.gallery))
    assert minplus.launches == before  # CPU tensors take the plain min-sum

    np.testing.assert_allclose(res.qf.numpy(), qf, rtol=2e-4, atol=2e-4)
    assert res.distmat.shape == want.shape == (len(q_pids), len(g_pids))
    np.testing.assert_allclose(res.distmat.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(res.cmc, cmc_want)
    assert abs(res.mAP - map_want) < 1e-6


def test_rrs_rows_path_matches_dense_single_clip(model_pair):
    """One clip per tracklet: the rrs row path and the dense path agree when
    every tracklet yields exactly one clip."""
    _, tcnn, tsia = model_pair
    ds = SyntheticVideoReID(**{**CATALOG, "frames_range": (T, T + 1)})
    ev = Evaluator(tcnn, tsia, micro_batch=5, device="cpu")
    rows, pids, _ = ev.extract_features(
        ClipLoader(ClipDataset(ds.gallery, T, "rrs_test", H, W), batch_size=7, workers=2))
    dense, pids2, _ = ev.extract_features(
        ClipLoader(ClipDataset(ds.gallery, T, "dense", H, W), batch_size=1, workers=2))
    np.testing.assert_array_equal(pids, pids2)
    np.testing.assert_allclose(rows.numpy(), dense.numpy(), rtol=1e-5, atol=1e-6)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert next(tm.create("siamese", input_num=8, output_num=4).parameters()).is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.create("siamese", input_num=8, output_num=4)
    sia = tm.create("siamese", device="cpu", input_num=8, output_num=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Evaluator(sia, sia)


def test_port_imports_neither_jax_nor_grl_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import grl_tpu_torch\n"
        "for m in pkgutil.walk_packages(grl_tpu_torch.__path__, 'grl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "entry = ['grl_tpu_torch.cli.train', 'grl_tpu_torch.cli.evaluate', 'grl_tpu_torch.data.jpeg',\n"
        "         'grl_tpu_torch.data.catalogs', 'grl_tpu_torch.utils.serialization',\n"
        "         'grl_tpu_torch.cli.extract', 'grl_tpu_torch.client',\n"
        "         'grl_tpu_torch.tools.bench_scaling', 'grl_tpu_torch.tools.bench_eval_tail',\n"
        "         'grl_tpu_torch.tools.make_fake_mars', 'grl_tpu_torch.tools.make_fake_duke',\n"
        "         'grl_tpu_torch.tools.prepare_real_data', 'grl_tpu_torch.tools.profile_train_step',\n"
        "         'grl_tpu_torch.entry', 'grl_tpu_torch.tools.learning_equivalence',\n"
        "         'grl_tpu_torch.bench']\n"
        "for name in entry:\n"
        "    importlib.import_module(name)\n"
        "assert all(name in sys.modules for name in entry)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'grl_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean', len([k for k in sys.modules if k.startswith('grl_tpu_torch')]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
