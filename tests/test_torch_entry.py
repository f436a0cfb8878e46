"""The port's entry hooks (``grl_tpu_torch/entry.py``) against grl_tpu's
(``__graft_entry__.py``), on the CPU.

``entry("cpu")``: the example batch and the forward's output shapes
against ``jax.eval_shape`` of the JAX hook's forward (no full-size
compute on either side: the port's module runs on meta tensors, and the
JAX hook's parameters are abstract), and the same parameter and BatchNorm
statistic counts. ``dryrun_multichip(n, device="cpu")`` at n = 1, 2, 3 on
gloo ranks, each launch with its own timeout: every rank finite and equal
to the others; the distances' protocol against grl_tpu's
``evaluate_device`` and each rank's re-ranking against the port's
one-process builder and grl_tpu's ``re_ranking_device`` (interpret mode)
on the same inputs, within 1e-5; the printed line in the JAX hook's format
(its own line, from a subprocess at n = 1).
"""

import os
import os.path as osp
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jhooks
from grl_tpu.engine.metrics import evaluate_device as j_evaluate_device
from grl_tpu.engine.rerank import re_ranking_device
from grl_tpu_torch import entry as hooks
from grl_tpu_torch import ops
from grl_tpu_torch.engine.rerank import re_ranking

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TIMEOUT = 180  # seconds a dry run's ranks may take before they are killed
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_entry():
    """The JAX hook's ``(forward, (params, state, clips))`` with abstract
    parameters: its ``init`` under ``jax.eval_shape``, no compilation cache."""
    from grl_tpu import models
    from grl_tpu.utils import profiling

    mp = pytest.MonkeyPatch()
    create = models.create

    mp.setattr(profiling, "enable_compilation_cache", lambda *a, **k: None)
    mp.setattr(models, "create", lambda name, **kw: _Abstract(create(name, **kw)))
    try:
        yield jhooks.entry()
    finally:
        mp.undo()


class _Abstract:
    """A grl_tpu model whose ``init`` returns shapes only."""

    def __init__(self, model):
        self._model = model

    def init(self, rng):
        return jax.eval_shape(self._model.init, rng)

    def __getattr__(self, name):
        return getattr(self._model, name)


def test_entry_matches_the_jax_hook_in_shapes(jax_entry):
    forward, jargs = jax_entry
    module, (clips,) = hooks.entry("cpu")
    assert tuple(clips.shape) == jargs[2].shape == hooks.CLIP_SHAPE == (2, 8, 256, 128, 3)
    assert clips.dtype == torch.float32 and str(jargs[2].dtype) == "float32"
    assert clips.device.type == "cpu" and not bool(clips.any())
    assert not module.training and all(not m.training for m in module.modules())
    assert all(p.device.type == "cpu" for p in module.parameters())

    want = jax.eval_shape(forward, *jargs)
    with torch.no_grad():
        got = module.to("meta")(torch.zeros(clips.shape, device="meta"))
    assert [tuple(o.shape) for o in got] == [w.shape for w in want] == [(2, 2048), (2, 8, 2048)]
    assert [o.dtype for o in got] == [torch.float32] * 2 and [str(w.dtype) for w in want] == ["float32"] * 2

    # the same model: as many parameters and BatchNorm statistics
    size = lambda tree: sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))
    n_params = sum(p.numel() for p in module.parameters())
    n_stats = sum(b.numel() for name, b in module.named_buffers() if not name.endswith("num_batches_tracked"))
    assert n_params == size(jargs[0]) and n_stats == size(jargs[1])


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: entry() runs there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hooks.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hooks.dryrun_multichip(1)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_dryrun_multichip_on_gloo_ranks(n, capsys):
    ranks = hooks.dryrun_multichip(n, device="cpu", timeout=TIMEOUT)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert [r["rank"] for r in ranks] == list(range(n))
    assert all(r["backend"] == "gloo" and r["device"] == "cpu" for r in ranks)
    assert all(r["launches"] == {"minplus": 0, "nearest": 0} for r in ranks)  # CPU tensors take the plain versions
    r0 = ranks[0]
    assert np.isfinite(r0["loss"]) and 0.0 <= r0["prec_frame"] <= 1.0
    for r in ranks[1:]:  # the global batch's metrics and the whole results, on every rank
        assert (r["loss"], r["prec_frame"], r["mAP"], r["cmc"]) == (r0["loss"], r0["prec_frame"], r0["mAP"], r0["cmc"])
        np.testing.assert_array_equal(r["rerank"], r0["rerank"])

    _, _, feats, ids = hooks.dryrun_data(n)
    cmc, mAP = j_evaluate_device(-(feats[:n] @ feats[n:].T), ids["q_pids"], ids["g_pids"], ids["q_cams"],
                                 ids["g_cams"], max_rank=5)
    assert abs(r0["mAP"] - float(mAP)) <= TOL
    np.testing.assert_allclose(r0["cmc"], np.asarray(cmc), rtol=0, atol=TOL)

    d = -(feats @ feats.T)
    k1, k2 = hooks.RERANK_K
    want = np.asarray(re_ranking_device(d[:n, n:], d[:n, :n], d[n:, n:], k1=k1, k2=k2, interpret=True))
    t = torch.from_numpy(d)
    one = re_ranking(t[:n, n:], t[:n, :n], t[n:, n:], k1=k1, k2=k2, min_sum_fn=ops.minplus_plain).numpy()
    assert r0["rerank"].shape == want.shape == (n, 2 * n)
    np.testing.assert_allclose(r0["rerank"], one, rtol=0, atol=TOL)
    np.testing.assert_allclose(r0["rerank"], want, rtol=0, atol=TOL)

    assert line == (f"dryrun_multichip({n}): loss={r0['loss']:.4f} prec_frame={r0['prec_frame']:.3f} "
                    f"eval(mAP={r0['mAP']:.3f}, rerank {(n, 2 * n)}) ok")


def test_dryrun_line_is_the_jax_hook_s(capsys):
    """The JAX hook's own line at n = 1 (a subprocess: it forces its CPU
    devices before any backend) and the port's have one format: equal once
    each number is replaced by its count of decimals."""
    code = "import __graft_entry__ as g\ng.dryrun_multichip(1)\n"
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    theirs = out.stdout.strip().splitlines()[-1]
    hooks.dryrun_multichip(1, device="cpu", timeout=TIMEOUT)
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    shape = lambda s: re.sub(r"\d+\.(\d+)", lambda m: f"<{len(m.group(1))}>", s)
    assert shape(ours) == shape(theirs)
    assert theirs.endswith("eval(mAP=1.000, rerank (1, 2)) ok") and ours.endswith("eval(mAP=1.000, rerank (1, 2)) ok")
