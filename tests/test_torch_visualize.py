"""Ranked strips and attention maps of the port (``engine/visualize.py``,
``--visual``, ``--visual-from``) on the CPU, against grl_tpu's.

Both packages' ``visualize_ranked_results`` on one distance matrix and
item list write the same tree of pixel-equal PNGs; the port's
``cli.evaluate --visual 1 --save-distmat`` then ``--visual-from`` gives
the live run's rank-1 and mAP and the same strips, as grl_tpu's
``--visual-from`` does on the same file; the GCE masks of
``attention_masks`` equal grl_tpu's.
"""

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from grl_tpu import models as jm
from grl_tpu.cli import evaluate as j_eval
from grl_tpu.data.transforms import normalize as j_normalize
from grl_tpu.engine import visualize as jvis
from grl_tpu_torch import models as tm
from grl_tpu_torch.cli import evaluate as t_eval
from grl_tpu_torch.cli import train as t_train
from grl_tpu_torch.engine import Evaluator, metrics
from grl_tpu_torch.engine import visualize as tvis
from grl_tpu_torch.utils import state_dict_from_jax
from test_torch_flow import FLOW, flow_layout, run

TINY = ["-d", "synthetic", "--tiny", "--seq_len", "2", "-j", "2"]


def tree(root):
    """{relative path: pixels} of every PNG under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): np.asarray(Image.open(p)) for p in sorted(root.rglob("*.png"))}


def assert_same_tree(got, want):
    got, want = tree(got), tree(want)
    assert got and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ranked_results_equal_grl_tpu(tmp_path):
    """Array frames and JPEG paths, ties in the distances, junk entries."""
    root = flow_layout(tmp_path, num_ids=3, frames_per_cam=4)
    paths = sorted(str(p) for p in Path(root, "images").glob("*.jpg"))
    rng = np.random.RandomState(0)
    query = [(rng.randint(0, 256, (2, 16, 8, 3), np.uint8), pid, 0) for pid in range(3)]
    gallery = list(query) + [(tuple(paths[i : i + 2]), i % 3, 1 + i % 2) for i in range(0, 20, 2)]
    distmat = np.round(rng.rand(len(query), len(gallery)), 1)  # ties
    tvis.visualize_ranked_results(distmat, query, gallery, str(tmp_path / "port"), topk=5)
    jvis.visualize_ranked_results(distmat, query, gallery, str(tmp_path / "jax"), topk=5)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port" / "query0000_pid0")) == 6


def test_in_pic_strips_equal_grl_tpu(tmp_path):
    rng = np.random.RandomState(1)
    items = [(rng.randint(0, 256, (1, 16, 8, 3), np.uint8), i % 3, i % 2) for i in range(6)]
    distmat = rng.rand(2, 6)
    tvis.visualize_in_pic(distmat, items[:2], items, str(tmp_path / "port"), topk=3)
    jvis.visualize_in_pic(distmat, items[:2], items, str(tmp_path / "jax"), topk=3)
    assert_same_tree(tmp_path / "port", tmp_path / "jax")
    frame = rng.randn(16, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(tvis.reverse_normalize(frame), jvis.reverse_normalize(frame))


def test_visual_then_visual_from_round_trip(tmp_path, monkeypatch):
    """``--visual 1 --save-distmat`` (live, re-ranked) then ``--visual-from``
    on its npz: the same rank-1, mAP and strips; grl_tpu's ``--visual-from``
    on the same npz agrees."""
    logs = tmp_path / "run"
    run(t_train, TINY + ["-b", "4", "--epochs", "1", "--logs-dir", str(logs)])
    ckpt = str(logs / "checkpoint.npz")
    evals, protocols = [], []
    live_evaluate, host_evaluate = Evaluator.evaluate, metrics.evaluate
    monkeypatch.setattr(Evaluator, "evaluate", lambda self, *a, **k: evals.append(live_evaluate(self, *a, **k))
                        or evals[-1])
    monkeypatch.setattr(metrics, "evaluate", lambda *a, **k: protocols.append(host_evaluate(*a, **k))
                        or protocols[-1])
    dist = str(tmp_path / "dist.npz")
    live = tmp_path / "live"
    top1 = run(t_eval, TINY + ["--seed", "0", "--logs-dir", str(live), "--checkpoint", ckpt, "--rerank", "1",
                               "--visual", "1", "--save-distmat", dist])
    again = tmp_path / "again"
    top1_from = run(t_eval, TINY + ["--seed", "0", "--logs-dir", str(again), "--visual-from", dist])
    assert top1_from == top1 == float(evals[-1].cmc[0])
    np.testing.assert_array_equal(protocols[-1][0], evals[-1].cmc)
    assert protocols[-1][1] == pytest.approx(evals[-1].mAP, rel=1e-12)
    assert_same_tree(again / "visual", live / "visual")
    theirs = tmp_path / "jax"
    j_top1 = run(j_eval, TINY + ["--seed", "0", "--logs-dir", str(theirs), "--visual-from", dist], port=False)
    assert j_top1 == top1_from
    assert_same_tree(again / "visual", theirs / "visual")


def test_visual_from_rejects_another_catalog(tmp_path):
    dist = tmp_path / "dist.npz"
    np.savez(dist, distmat=np.zeros((2, 3)), q_pids=[0, 1], g_pids=[0, 1, 2], q_camids=[0, 0], g_camids=[1, 1, 1])
    with pytest.raises(SystemExit, match="same dataset/split"):
        run(t_eval, TINY + ["--seed", "0", "--logs-dir", str(tmp_path), "--visual-from", str(dist)])


def test_visual_flag_on_flow_evaluation(tmp_path):
    """``cli.evaluate --use-flow --visual 1``: strips of the RGB frames."""
    root = flow_layout(tmp_path / "data")
    logs = tmp_path / "run"
    run(t_train, FLOW + ["--data-dir", root, "-b", "4", "--epochs", "1", "--logs-dir", str(logs)])
    run(t_eval, FLOW + ["--data-dir", root, "--logs-dir", str(logs), "--checkpoint", str(logs / "checkpoint.npz"),
                        "--visual", "1"])
    strips = tree(logs / "visual")
    assert strips and all(v.shape == (64, 32, 3) for v in strips.values())
    assert sum(k.endswith("query.png") for k in strips) == 6


@pytest.mark.parametrize("channels", [3, 6])
def test_attention_masks_equal_grl_tpu(tmp_path, channels):
    jg = jm.GRLModel(trunk=jm.ResNetTrunk(layers=(1, 1, 1, 1), width=4, in_channels=channels))
    tg = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), width=4, in_channels=channels))
    params, state = jg.init(jax.random.PRNGKey(0))
    params, state = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    tg.load_state_dict(state_dict_from_jax(params, state, tg), strict=True)
    clips = np.random.RandomState(2).randint(0, 256, (2, 3, 64, 32, channels)).astype(np.uint8)
    (_, _, corr), _ = jg.children["backbone"].apply(params["backbone"], state["backbone"],
                                                    j_normalize(jnp.asarray(clips)), training=False)
    want = np.moveaxis(np.asarray(corr)[..., 0], 0, 1)  # grl_tpu's backbone is time-major
    masks = tvis.visualize_attention(tg.eval(), clips, str(tmp_path), device="cpu")
    assert masks.shape == (2, 3, 4, 2)
    np.testing.assert_allclose(masks, want, rtol=0, atol=2e-4)
    assert sorted(os.listdir(tmp_path)) == ["cam_000.png", "cam_001.png"]
    if channels == 3:
        jvis.visualize_attention(jg, params, state, clips, str(tmp_path / "jax"))
        assert sorted(os.listdir(tmp_path / "jax")) == ["cam_000.png", "cam_001.png"]
    overlay = tvis.attention_overlay(clips[0, 0, ..., :3], masks[0, 0])
    np.testing.assert_array_equal(overlay, jvis.attention_overlay(clips[0, 0, ..., :3], masks[0, 0]))
