"""The port's headline benchmark (``grl_tpu_torch/bench.py``) against the
root ``bench.py``: the printed keys read from bench.py's source, the
evaluation tail against grl_tpu's ``cosine_distance`` + ``evaluate_device``
on the same seeded features, and ``main`` on the CPU at small sizes.
"""

import ast
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from grl_tpu_torch import bench, precision_flags, set_precision_flags

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench_py_keys():
    """The keys of the dict that bench.py's ``main`` passes to ``json.dumps``."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    dumps = [node for node in ast.walk(tree) if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute) and node.func.attr == "dumps"]
    assert len(dumps) == 1 and isinstance(dumps[0].args[0], ast.Dict)
    return [key.value for key in dumps[0].args[0].keys]


@pytest.fixture
def small(monkeypatch):
    """The module's sizes cut small (the models stay full width), and the
    precision flags that ``main`` sets put back after the test."""
    for name, value in dict(MICRO_BATCH=2, SEQ_LEN=2, H=32, W=16, GALLERY_Q=20, GALLERY_EXTRA_G=60,
                            GALLERY_DIM=16).items():
        monkeypatch.setattr(bench, name, value)
    flags = precision_flags()
    yield
    set_precision_flags(flags)


def test_bench_py_prints_eight_keys():
    assert bench_py_keys() == ["metric", "value", "unit", "vs_baseline", "baseline", "vs_nominal_100",
                               "gallery_queries_per_sec", "gallery_scale"]


def test_main_on_cpu_prints_bench_py_keys(small):
    keys = bench_py_keys()
    out = io.StringIO()
    with redirect_stdout(out):
        line = bench.main(["--device", "cpu"])
    printed = out.getvalue().splitlines()
    assert len(printed) == 1 and json.loads(printed[0]) == line
    assert list(line) == keys
    assert line["metric"] == "mars_clip_features_per_sec_per_chip" and line["unit"] == "clips/s"
    for key in ("value", "vs_baseline", "vs_nominal_100", "gallery_queries_per_sec"):
        assert np.isfinite(line[key]) and line[key] > 0, (key, line[key])
    assert "1 H100 vs 1 host core" in line["baseline"]
    assert line["gallery_scale"].startswith("MARS 20x80, 16-d")


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(bench, "descriptor_clips_per_sec", lambda *a, **k: called.append(a))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])
    assert not called


@pytest.mark.parametrize("q,extra_g,dim", [(40, 120, 64), (20, 60, 16)])
def test_gallery_tail_equals_grl_tpu(q, extra_g, dim):
    import jax.numpy as jnp

    from grl_tpu.engine import metrics as J
    from grl_tpu.engine.evaluator import cosine_distance as j_cosine

    rng = np.random.RandomState(7)
    feats = rng.randn(q + extra_g, dim).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    qf, gf = feats[:q], np.concatenate([feats[:q], feats[q:]])
    ids = bench.gallery_ids(q, extra_g)
    # bench.py's draw order: query pids, more gallery pids, query cameras, more gallery cameras
    want_rng = np.random.RandomState(0)
    q_pids = want_rng.randint(0, q, q)
    g_more = want_rng.randint(0, q, extra_g)
    q_cams = want_rng.randint(0, 6, q)
    np.testing.assert_array_equal(ids[0], q_pids)
    np.testing.assert_array_equal(ids[1], np.concatenate([q_pids, g_more]))
    np.testing.assert_array_equal(ids[2], q_cams)
    np.testing.assert_array_equal(ids[3], np.concatenate([q_cams, want_rng.randint(0, 6, extra_g)]))

    cmc, mAP = bench.gallery_tail(torch.from_numpy(qf), torch.from_numpy(gf), *ids)
    want_cmc, want_mAP = J.evaluate_device(j_cosine(jnp.asarray(qf), jnp.asarray(gf)), *ids)
    np.testing.assert_array_equal(cmc, np.asarray(want_cmc))
    assert abs(mAP - float(want_mAP)) <= 1e-6
    assert cmc.shape == (min(100, q + extra_g),)
