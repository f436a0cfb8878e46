"""The optical-flow configuration (``--use-flow``) of the port on the CPU,
against grl_tpu's.

``--use-flow`` trains the GRL model on 6-channel clips, RGB then the flow
companion of each frame (``others/`` beside ``images/`` in the iLIDS-VID
and PRID-2011 layouts), through a trunk whose conv1 takes 6 channels.
Held here: the 6-channel augmentation and erasing, the flow batches of
``ClipDataset``/``get_data`` (byte-equal), the ImageNet conv1 inflation,
and one tiny run of the CLIs: the port's ``cli.train --use-flow`` writes a
checkpoint, both packages' ``cli.evaluate --use-flow --rerank 1`` give
distance matrices within 1e-4, both ``features --use-flow`` agree, and
the port's flow artifact (``channels: 6``) is served by its daemon.

The layout helper (``flow_layout``) writes 64x32 JPEGs under ``images/``
and their flow companions under ``others/``; by hand::

    python -c "import sys; sys.path.insert(0, 'tests'); from test_torch_flow import flow_layout; \\
        print(flow_layout('/tmp/flow'))"
"""

import base64
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu.cli import evaluate as j_eval
from grl_tpu.cli import extract as j_extract
from grl_tpu.data import ClipDataset as JClipDataset
from grl_tpu.data import get_data as j_get_data
from grl_tpu.data import transforms as jtransforms
from grl_tpu.data.catalogs import iLIDSVIDSequence as JiLIDS
from grl_tpu_torch import models
from grl_tpu_torch.cli import evaluate as t_eval
from grl_tpu_torch.cli import extract as t_extract
from grl_tpu_torch.cli import train as t_train
from grl_tpu_torch.data import ClipDataset, get_data, transforms
from grl_tpu_torch.data.catalogs import iLIDSVIDSequence
from grl_tpu_torch.utils import load_imagenet_resnet50, state_dict_from_jax
from test_sequence_catalogs import make_layout
from test_torch_catalogs import assert_same_batches

FLOW = ["-d", "ilidsvidsequence", "--tiny", "--use-flow", "--seq_len", "2", "--seq_srd", "2", "-j", "2"]
DISTMAT_ATOL = 1e-4
DIM = 384  # 3 x the tiny trunk's 128 features


def flow_layout(path, num_ids=4, frames_per_cam=8):
    """An iLIDS-VID layout with flow companions under ``path``; its root."""
    return make_layout(Path(path), num_ids=num_ids, frames_per_cam=frames_per_cam, flow=True)


def run(module, argv, port=True):
    """``module.main`` on ``argv`` (the port's on the CPU), restoring
    ``sys.stdout`` after the tee logger."""
    args = module.build_parser().parse_args(argv + (["--device", "cpu"] if port else []))
    stdout = sys.stdout
    try:
        return module.main(args)
    finally:
        sys.stdout = stdout


def extract(module, *argv, port=True):
    pre = ["--device", "cpu"] if port else []
    stdout = sys.stdout
    try:
        return module.main(module.build_parser().parse_args(pre + list(argv)))
    finally:
        sys.stdout = stdout


@pytest.fixture(scope="module")
def flow_run(tmp_path_factory):
    """A flow layout and one epoch of the port's ``cli.train --use-flow``."""
    tmp = tmp_path_factory.mktemp("flow")
    root = flow_layout(tmp)
    logs = tmp / "run"
    top1 = run(t_train, FLOW + ["--data-dir", root, "-b", "4", "--epochs", "1", "--logs-dir", str(logs)])
    return root, logs, top1


# ---- transforms ----

def test_augment_eval_on_six_channels_equals_grl_tpu():
    clips = np.random.RandomState(0).randint(0, 256, (2, 3, 32, 16, 6)).astype(np.uint8)
    want = np.asarray(jtransforms.augment(jax.random.PRNGKey(0), jnp.asarray(clips), train=False))
    got = transforms.augment(torch.Generator().manual_seed(0), torch.from_numpy(clips), train=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the flow half takes the ImageNet statistics again
    np.testing.assert_allclose(got[..., 3:].numpy(), transforms.normalize(torch.from_numpy(clips[..., 3:])).numpy())


def test_erase_on_six_channels_with_grl_tpu_draws():
    clips = np.random.RandomState(1).randint(0, 256, (2, 3, 32, 16, 6)).astype(np.uint8)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jtransforms.random_erase(key, jnp.asarray(clips)))
    b, t, h, w, c = clips.shape
    n = b * t
    k_gate, k_area, k_aspect, k_x, k_y, k_color = jax.random.split(key, 6)
    draws = dict(
        gate=jax.random.uniform(k_gate, (n,)) <= 0.5,
        area=jax.random.uniform(k_area, (n,), minval=0.02, maxval=0.2) * (h * w),
        aspect=jax.random.uniform(k_aspect, (n,), minval=0.3, maxval=1.0 / 0.3),
        ux=jax.random.uniform(k_x, (n,)),
        uy=jax.random.uniform(k_y, (n,)),
        color=jax.random.randint(k_color, (n, c), 0, 256).astype(jnp.uint8),
    )
    got = transforms.erase(torch.from_numpy(clips), **{k: torch.tensor(np.asarray(v)) for k, v in draws.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != clips).any()


# ---- the flow data path ----

@pytest.mark.parametrize("sample", ["rrs_train", "rrs_test", "dense", "random"])
def test_clip_dataset_flow_map_equals_grl_tpu(tmp_path, sample):
    root = flow_layout(tmp_path)
    ours, theirs = iLIDSVIDSequence(root, seq_len=2, seq_srd=2), JiLIDS(root, seq_len=2, seq_srd=2)
    a = ClipDataset(ours.trainval, 2, sample, 32, 16, seed=3, flow_map=ours.flow_paths_for)
    b = JClipDataset(theirs.trainval, 2, sample, 32, 16, seed=3, flow_map=theirs.flow_paths_for)
    for i in range(len(a)):
        got, want = a.get(i, epoch=1), b.get(i, epoch=1)
        assert got[0].dtype == np.uint8 and got[0].shape[-1] == 6
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    # the flow half is the companion frame (the layout's flow is 255 - rgb)
    clip = a.get(0)[0]
    assert not np.array_equal(clip[..., :3], clip[..., 3:])


def test_get_data_use_flow_equals_grl_tpu(tmp_path):
    root = flow_layout(tmp_path)
    kw = dict(batch_size=4, seq_len=2, seq_srd=2, workers=2, height=32, width=16, use_flow=True)
    for only_eval in (False, True):
        ours = get_data("ilidsvidsequence", root, only_eval=only_eval, **kw)
        theirs = j_get_data("ilidsvidsequence", root, only_eval=only_eval, **kw)
        assert ours[1] == theirs[1]
        for got, want in zip(ours[2:], theirs[2:]):
            if want is None:
                assert got is None
                continue
            assert_same_batches(got, want, n=3)
            assert next(iter(got))[0].shape[-1] == 6


# ---- ImageNet conv1 inflation ----

def test_imagenet_conv1_inflation_equals_grl_tpu():
    """A torchvision-named dict from a 3-channel trunk's state dict (plus an
    ``fc`` the loaders drop) into 6-channel trunks of both packages."""
    from grl_tpu import models as jm
    from grl_tpu.utils.convert_torch import load_imagenet_resnet50 as j_load

    src = models.ResNetTrunk(layers=(1, 1, 1, 1), width=4)
    models.init_weights(src, torch.Generator().manual_seed(0))
    flat = {k: v.numpy().copy() for k, v in src.state_dict().items()}
    flat["fc.weight"], flat["fc.bias"] = np.zeros((10, 128), np.float32), np.zeros(10, np.float32)

    ours = load_imagenet_resnet50(models.ResNetTrunk(layers=(1, 1, 1, 1), width=4, in_channels=6), flat)
    jt = jm.ResNetTrunk(layers=(1, 1, 1, 1), width=4, in_channels=6)
    p, s = jt.init(jax.random.PRNGKey(0))
    p, s = j_load(jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s), flat)
    want = state_dict_from_jax(p, s, ours)
    for k, v in ours.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    w = ours.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(w[:, :3], flat["conv1.weight"] / 2)
    np.testing.assert_array_equal(w[:, 3:], flat["conv1.weight"] / 2)

    with pytest.raises(ValueError, match="non-multiple"):
        load_imagenet_resnet50(models.ResNetTrunk(layers=(1, 1, 1, 1), width=4, in_channels=4), flat)


# ---- the CLIs ----

def test_train_builds_a_six_channel_trunk(flow_run):
    _, logs, top1 = flow_run
    assert 0.0 <= top1 <= 1.0 and (logs / "checkpoint.npz").exists()
    args = t_train.build_parser().parse_args(FLOW)
    cnn, _, _ = t_train.build_models(args, tiny=True)
    assert cnn.backbone.base.conv1.in_channels == 6
    full, _, _ = t_train.build_models(t_train.build_parser().parse_args(["--use-flow", "-d", "ilidsvidsequence"]))
    assert tuple(full.backbone.base.conv1.weight.shape) == (64, 6, 7, 7) and full.num_feat == 2048


def test_one_flow_checkpoint_through_both_evaluate_clis(flow_run, tmp_path):
    root, logs, _ = flow_run
    argv = FLOW + ["--data-dir", root, "--logs-dir", str(tmp_path), "--checkpoint", str(logs / "checkpoint.npz"),
                   "--rerank", "1"]
    run(j_eval, argv + ["--save-distmat", str(tmp_path / "jax.npz")], port=False)
    run(t_eval, argv + ["--save-distmat", str(tmp_path / "port.npz")])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    for k in ("q_pids", "q_camids", "g_pids", "g_camids", "rerank"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bool(got["rerank"]) and got["distmat"].shape == want["distmat"].shape
    np.testing.assert_allclose(got["distmat"], want["distmat"], rtol=0, atol=DISTMAT_ATOL)


def test_features_and_flow_artifact(flow_run, tmp_path):
    """``features --use-flow`` of both packages, then the port's
    ``export-model --use-flow`` and its daemon's ``describe``."""
    root, logs, _ = flow_run
    ckpt = str(logs / "checkpoint.npz")
    common = ["-d", "ilidsvidsequence", "--data-dir", root, "--tiny", "--use-flow", "--seq_len", "2",
              "--seq_srd", "2", "-j", "2", "--checkpoint", ckpt, "--split", "gallery"]
    shape = extract(t_extract, "features", *common, "-o", str(tmp_path / "port.npz"))
    want_shape = extract(j_extract, "features", *common, "-o", str(tmp_path / "jax.npz"), port=False)
    assert tuple(shape) == tuple(want_shape) == (tuple(shape)[0], DIM)
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    np.testing.assert_array_equal(got["pids"], want["pids"])
    np.testing.assert_allclose(got["features"], want["features"], rtol=0, atol=DISTMAT_ATOL)

    model = str(tmp_path / "model.npz")
    meta = extract(t_extract, "export-model", "--checkpoint", ckpt, "--tiny", "--use-flow", "--num-classes", "2",
                   "--batch", "2", "--seq_len", "2", "--height", "64", "--width", "32", "-o", model)
    assert meta["channels"] == 6 and meta["dim"] == DIM
    rng = np.random.RandomState(0)
    clips = rng.randint(0, 256, (3, 2, 64, 32, 6), np.uint8)
    np.savez(tmp_path / "clips.npz", clips=clips)
    np.savez(tmp_path / "rgb.npz", clips=clips[..., :3])
    out = io.StringIO()
    reqs = [{"op": "ping"}, {"op": "describe", "clips": str(tmp_path / "clips.npz")},
            {"op": "describe", "clips": str(tmp_path / "rgb.npz")}, {"op": "shutdown"}]
    t_extract.serve(t_extract.build_parser().parse_args(["--device", "cpu", "serve", "--model", model]),
                    inp=io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)), out=out)
    resp = [json.loads(line) for line in out.getvalue().splitlines()]
    assert resp[0]["channels"] == 6
    feats = np.load(io.BytesIO(base64.b64decode(resp[1]["npz_b64"])))["features"]

    args = t_train.build_parser().parse_args(FLOW)
    cnn, sia, unc = t_train.build_models(args, tiny=True)
    from grl_tpu_torch.engine import init_train_state, make_descriptor_fn
    from grl_tpu_torch.utils import load_train_state

    state = init_train_state(cnn, sia, unc, 2, num_feat=cnn.num_feat, device="cpu")
    load_train_state(state, ckpt)
    with torch.inference_mode():
        ref = make_descriptor_fn(cnn.eval(), sia.eval())(torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(feats, ref, rtol=0, atol=1e-4)
    assert not resp[2]["ok"] and "exported for (2, 64, 32, 6)" in resp[2]["error"]
