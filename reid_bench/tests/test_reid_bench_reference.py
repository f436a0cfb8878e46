"""The plain references agree with the system at small sizes on the CPU:
the descriptor, a training step (loss, gradients, update, tables) and
k-reciprocal re-ranking; the operation counts agree with PyTorch's flop
counter on the system's own calls; and the references and traffic import
nothing of the system."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from reid_bench import counts, weights
from reid_bench.reference import grl as ref
from reid_bench.reference import rerank as ref_rerank
from reid_bench.reference import sampling
from reid_bench.reference import train as ref_train
from reid_bench.tests.conftest import TINY_CONFIG
from reid_bench.traffic import frames

PKG = Path(ref.__file__).resolve().parents[1]


def _models(cd=None):
    from grl_tpu_torch.models import GRLModel, ResNetTrunk, Siamese, SiameseVideo

    c = TINY_CONFIG
    cnn = GRLModel(trunk=ResNetTrunk(tuple(c["trunk_layers"]), width=c["trunk_width"], compute_dtype=cd),
                   compute_dtype=cd)
    return cnn, Siamese(c["feat_dim"], c["siamese_out"], compute_dtype=cd), SiameseVideo(c["feat_dim"], c["feat_dim"])


def _clips(n, seed=0):
    pool = frames.frame_pool(seed, 64, TINY_CONFIG["height"], TINY_CONFIG["width"], 8, 0.08, "cpu")
    t = TINY_CONFIG["seq_len"]
    return torch.from_numpy(np.stack([pool[i * t : (i + 1) * t] for i in range(n)]))


@pytest.mark.parametrize("seed", [0, 1])
def test_descriptor_matches_the_system(seed):
    from grl_tpu_torch.engine import make_descriptor_fn

    cnn, siamese, _ = _models()
    w = weights.generate(weights.shapes_of(("cnn", cnn), ("siamese", siamese)), seed, "cpu")
    clips = _clips(6, seed)
    ref.calibrate(w, clips, TINY_CONFIG["trunk_layers"])
    weights.load(w, ("cnn", cnn), ("siamese", siamese))
    with torch.no_grad():
        mine = ref.descriptor(ref.Net(w), clips, TINY_CONFIG["trunk_layers"])
        theirs = make_descriptor_fn(cnn.eval(), siamese.eval())(clips)
    assert torch.allclose(mine, theirs, atol=1e-5, rtol=1e-5)
    # calibrated: clips differ by far more than rounding
    assert float((mine[0] - mine[1]).norm() / mine[0].norm()) > 0.05


def test_training_step_matches_the_system():
    from grl_tpu_torch.data.transforms import augment
    from grl_tpu_torch.engine.train_step import init_train_state, make_train_step

    cnn, siamese, video = _models()
    parts = (("cnn", cnn), ("siamese", siamese), ("siamese_uncorr", video))
    w = weights.generate(weights.shapes_of(*parts), 3, "cpu")
    weights.load(w, *parts)
    state = init_train_state(cnn, siamese, video, 6, num_feat=TINY_CONFIG["feat_dim"], device="cpu")
    step = make_train_step(device="cpu")
    clips_u8, ids = _clips(8, 3)[:4], torch.tensor([1, 1, 2, 4])
    gen = torch.Generator().manual_seed(9)
    _, m = step(state, augment(gen, clips_u8), ids, 1e-3)
    named = dict(state.models.named_parameters())

    losses, grads, after = ref_train.train_steps(w, [(clips_u8, ids)], torch.Generator().manual_seed(9),
                                                 TINY_CONFIG["trunk_layers"], 6, 1e-3)
    assert abs(losses[0] - float(m["loss"])) <= 1e-5 * abs(losses[0])
    # fp32 in two formulations: each leaf within 1e-3 of its own norm, but for
    # leaves whose gradient is nought to rounding (a bias before train-mode BN)
    median = float(np.median([float(g.norm()) for g in grads.values()]))
    for k, p in named.items():
        if float(grads[k].norm()) < 1e-3 * median:
            continue
        g = state.optimizer.state[p]["momentum_buffer"] - 5e-4 * w[k]
        assert float((g - grads[k]).norm()) <= 1e-3 * float(grads[k].norm()) + 1e-9, k
        step, ref_step = p.detach() - w[k], after[k] - w[k]
        assert float((step - ref_step).norm()) <= 1e-3 * float(ref_step.norm()) + 1e-9, k
    corr = ref_train.lut_updated(torch.zeros(6, 128), torch.ones(2, 128) / 128**0.5, torch.tensor([1, 1]))
    assert torch.allclose(corr[1].norm(), torch.tensor(1.0))


def test_sampling_matches_the_system():
    from grl_tpu_torch.data.loader import ClipDataset
    from grl_tpu_torch.data.sampling import RandomPairSampler, dense_indices

    for n in (1, 7, 8, 9, 16, 17, 58):
        assert np.array_equal(sampling.dense_indices(n, 8), dense_indices(n, 8))
    rng = np.random.RandomState(0)
    items = [(np.zeros((int(n), 2, 2, 3), np.uint8), int(p), int(c))
             for n, p, c in zip(rng.randint(1, 30, 40), rng.randint(0, 9, 40), rng.randint(0, 3, 40))]
    pids, cams = [p for _, p, _ in items], [c for _, _, c in items]
    assert sampling.pair_order(pids, cams, 5, 48) == list(iter(RandomPairSampler(items, seed=5)))[:48]
    ds = ClipDataset(items, 8, "rrs_train", 2, 2, seed=5)
    for i in range(10):
        ds_rng = ds._item_rng(i, 0)
        assert np.array_equal(sampling.rrs_train_indices(len(items[i][0]), 8, sampling.item_rng(5, 0, i)),
                              __import__("grl_tpu_torch.data.sampling", fromlist=["x"]).rrs_train_indices(
                                  len(items[i][0]), 8, ds_rng))


@pytest.mark.parametrize("q,g", [(3, 40), (5, 70)])
def test_rerank_matches_the_system(q, g):
    from grl_tpu_torch.engine.evaluator import _euclidean, cosine_distance
    from grl_tpu_torch.engine.rerank import re_ranking

    rng = np.random.RandomState(q)
    centres = rng.standard_normal((6, 32)).astype(np.float32)
    qf = torch.from_numpy(frames_unit(centres[rng.randint(0, 6, q)] + 0.5 * rng.standard_normal((q, 32))))
    gf = torch.from_numpy(frames_unit(centres[rng.randint(0, 6, g)] + 0.5 * rng.standard_normal((g, 32))))
    gf = torch.cat([qf, gf])
    theirs = re_ranking(cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf))
    mine = ref_rerank.rerank(qf, gf)
    assert torch.allclose(mine, torch.as_tensor(theirs), atol=1e-5)


def frames_unit(x):
    x = np.asarray(x, np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_counts_match_the_flop_counter():
    from grl_tpu_torch.engine import make_descriptor_fn
    from grl_tpu_torch.engine.train_step import init_train_state, make_train_step

    cnn, siamese, video = _models()
    clips = _clips(3)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        make_descriptor_fn(cnn.eval(), siamese.eval())(clips)
    assert fc.get_total_flops() == 3 * counts.descriptor_ops(TINY_CONFIG)["total"]
    conv = sum(v for k, v in fc.get_flop_counts()["Global"].items() if "convolution" in str(k))
    assert conv == 3 * counts.descriptor_ops(TINY_CONFIG)["conv"]

    state = init_train_state(cnn, siamese, video, 10, num_feat=TINY_CONFIG["feat_dim"], device="cpu")
    x = torch.randn(4, TINY_CONFIG["seq_len"], TINY_CONFIG["height"], TINY_CONFIG["width"], 3)
    with FlopCounterMode(display=False) as fc:
        make_train_step(device="cpu")(state, x, torch.tensor([1, 1, 2, 2]), 1e-3)
    expected = counts.train_step_ops(TINY_CONFIG, 4, 10)
    assert fc.get_total_flops() == expected["total"]
    conv = sum(v for k, v in fc.get_flop_counts()["Global"].items() if "convolution" in str(k))
    assert conv == expected["conv"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("sub", ["reference", "traffic/frames.py"])
def test_references_and_generators_import_nothing_of_the_system(sub):
    paths = [PKG / sub] if sub.endswith(".py") else sorted((PKG / sub).glob("*.py"))
    for path in paths:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"grl_tpu_torch", "grl_tpu", "jax", "jaxlib", "flax"}, path
    code = ("import sys, reid_bench.reference.grl, reid_bench.reference.train, reid_bench.reference.rerank, "
            "reid_bench.reference.sampling, reid_bench.traffic.frames; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'grl_tpu_torch', 'grl_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=PKG.parent)
    assert out.stdout.strip() == "[]"
