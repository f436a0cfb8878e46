"""``Evaluator.describe_clips`` and its bucket rule against grl_tpu's.

grl_tpu's ``Evaluator.describe_clips`` splits clips into micro-batches and
pads each chunk with zero clips up to the smallest of ``micro_batch // 3``,
``micro_batch // 2`` and ``micro_batch`` that holds it; its rrs_test row
path and its tests describe through it. The port's must give the same
chunks, bucket shapes and valid counts, and rows within 1e-5 (fp32, the
same weights carried over with ``state_dict_from_jax`` and seeded BN
statistics). The export test is the port's counterpart of grl_tpu's
``test_export_model_describe_matches_evaluator``.
"""

import json
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from grl_tpu import models as jm
from grl_tpu.engine.evaluator import Evaluator as JEvaluator
from grl_tpu_torch import models as tm
from grl_tpu_torch.data import ClipDataset, ClipLoader, SyntheticVideoReID
from grl_tpu_torch.engine import Evaluator, make_descriptor_fn
from grl_tpu_torch.utils import state_dict_from_jax
from test_torch_models import WIDTH, randomize_bn

T, H, W = 3, 32, 16
MICRO_BATCH = 12
TOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    """grl_tpu's tiny GRL + Siamese with seeded BN statistics and its
    parameter trees; the port's modules loaded from the same trees."""
    jcnn = jm.GRLModel(trunk=jm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))
    jsia = jm.Siamese(input_num=jcnn.num_feat, output_num=16)
    params, state = {}, {}
    for name, mod, seed in (("cnn", jcnn, 11), ("siamese", jsia, 12)):
        p, s = mod.init(jax.random.PRNGKey(seed))
        params[name], state[name] = randomize_bn(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), seed)
    tcnn = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))
    tsia = tm.Siamese(input_num=tcnn.num_feat, output_num=16)
    for mod, name in ((tcnn, "cnn"), (tsia, "siamese")):
        mod.load_state_dict(state_dict_from_jax(params[name], state[name], mod), strict=True)
    return SimpleNamespace(jcnn=jcnn, jsia=jsia, params=params, state=state, tcnn=tcnn, tsia=tsia)


@pytest.mark.parametrize("micro_batch", [12, 96, 5, 2])
def test_bucket_rule_is_grl_tpu_s(micro_batch):
    """Every chunk size up to the micro-batch pads to grl_tpu's bucket
    (one device: grl_tpu's multiple of mesh devices is 1)."""
    want = JEvaluator(None, None, micro_batch=micro_batch)
    got = Evaluator(torch.nn.Identity(), torch.nn.Identity(), micro_batch=micro_batch, device="cpu")
    assert [got._bucket(s) for s in range(1, micro_batch + 1)] == [want._bucket(s) for s in range(1, micro_batch + 1)]


@pytest.mark.parametrize("n", [MICRO_BATCH + 3, MICRO_BATCH + 5, MICRO_BATCH + 12])
def test_describe_clips_matches_grl_tpu(pair, n):
    """n = 12+3, 12+5 and 12+12 at micro-batch 12: the buckets 4, 6 and 12
    after a full chunk; the same chunks, bucket shapes and valid counts,
    rows within 1e-5; the padded rows are the descriptor of zero clips."""
    clips = np.random.RandomState(n).randint(0, 256, (n, T, H, W, 3)).astype(np.uint8)
    want = JEvaluator(pair.jcnn, pair.jsia, micro_batch=MICRO_BATCH).describe_clips(pair.params, pair.state, clips)
    ev = Evaluator(pair.tcnn, pair.tsia, micro_batch=MICRO_BATCH, device="cpu")
    got = ev.describe_clips(clips)
    assert [(tuple(d.shape), size) for d, size in got] == [(tuple(np.shape(d)), size) for d, size in want]
    assert [size for _, size in got] == [MICRO_BATCH, n - MICRO_BATCH]
    assert all(d.device.type == "cpu" and d.dtype == torch.float32 for d, _ in got)
    for (d, size), (jd, _) in zip(got, want):
        np.testing.assert_allclose(d[:size].numpy(), np.asarray(jd)[:size], rtol=0, atol=TOL)
    d, size = got[-1]
    if d.shape[0] > size:
        with torch.inference_mode():
            zeros = make_descriptor_fn(pair.tcnn.eval(), pair.tsia.eval())(
                torch.zeros((1, T, H, W, 3), dtype=torch.uint8))
        np.testing.assert_allclose(d[size:].numpy(), zeros.expand(d.shape[0] - size, -1).numpy(), rtol=0, atol=TOL)


def test_rrs_rows_go_through_describe_clips(pair, monkeypatch):
    """The rrs_test row path describes each loader batch with
    ``describe_clips`` and keeps each chunk's valid rows, in order."""
    ds = SyntheticVideoReID(num_train_ids=0, num_test_ids=6, tracklets_per_id=2, num_cams=2, frames_range=(3, 8),
                            height=H, width=W, seed=0)
    ev = Evaluator(pair.tcnn, pair.tsia, micro_batch=MICRO_BATCH, device="cpu")
    calls = []
    describe_clips = ev.describe_clips

    def spy(clips):
        out = describe_clips(clips)
        calls.append((np.array(clips), out))
        return out

    monkeypatch.setattr(ev, "describe_clips", spy)
    feats, pids, _ = ev.extract_features(ClipLoader(ClipDataset(ds.gallery, T, "rrs_test", H, W), batch_size=7,
                                                    workers=2))
    assert len(pids) == len(ds.gallery) == feats.shape[0]
    assert len(calls) == -(-len(ds.gallery) // 7)
    assert {tuple(d.shape)[0] for _, out in calls for d, _ in out} <= {4, 6, 12}
    want = torch.cat([d[:size] for _, out in calls for d, size in out])
    np.testing.assert_array_equal(feats.numpy(), want.numpy())
    with torch.inference_mode():
        plain = make_descriptor_fn(pair.tcnn.eval(), pair.tsia.eval())(torch.from_numpy(np.concatenate(
            [c for c, _ in calls])))
    np.testing.assert_allclose(feats.numpy(), plain.numpy(), rtol=0, atol=TOL)


def test_export_model_describe_matches_describe_clips(tmp_path):
    """``extract describe`` of an artifact exported at batch 4 on six clips
    (the last chunk padded) against ``Evaluator.describe_clips`` on the same
    checkpoint at micro-batch 4."""
    from grl_tpu_torch.cli import extract as T_
    from grl_tpu_torch.engine import init_train_state
    from grl_tpu_torch.tools.make_random_checkpoint import write_random_checkpoint
    from grl_tpu_torch.utils import load_train_state

    ckpt = write_random_checkpoint(str(tmp_path / "ckpt.npz"), num_classes=4, tiny=True)
    run = lambda *argv: T_.main(T_.build_parser().parse_args(["--device", "cpu", *argv]))
    run("export-model", "--checkpoint", ckpt, "--tiny", "--num-classes", "4", "--batch", "4", "--seq_len", "2",
        "--height", "64", "--width", "32", "-o", str(tmp_path / "model.npz"))
    clips = np.random.RandomState(0).randint(0, 256, (6, 2, 64, 32, 3), np.uint8)
    np.savez(tmp_path / "clips.npz", clips=clips, pids=np.arange(6))
    run("describe", "--model", str(tmp_path / "model.npz"), "--clips", str(tmp_path / "clips.npz"), "-o",
        str(tmp_path / "feats.npz"))
    got = np.load(tmp_path / "feats.npz")
    assert list(got["pids"]) == list(range(6))
    assert json.loads(str(np.load(tmp_path / "model.npz")["meta"]))["batch"] == 4

    cnn, sia, unc = T_.build_models(SimpleNamespace(arch2="siamese", seed=0), tiny=True)
    state = init_train_state(cnn, sia, unc, 4, num_feat=cnn.num_feat, device="cpu")
    load_train_state(state, ckpt)
    chunks = Evaluator(cnn, sia, micro_batch=4, device="cpu").describe_clips(clips)
    assert [(d.shape[0], size) for d, size in chunks] == [(4, 4), (2, 2)]
    ref = torch.cat([d[:size] for d, size in chunks]).numpy()
    assert got["features"].shape == ref.shape == (6, 3 * cnn.num_feat)
    np.testing.assert_allclose(got["features"], ref, rtol=0, atol=2e-5)
