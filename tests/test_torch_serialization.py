"""Checkpoints cross between grl_tpu and the port, on the CPU.

Tiny widths as the CLIs' ``--tiny`` (trunk layers (1, 1, 1, 1), width 4,
128 channels out; ``Siamese(128, 512)``, ``SiameseVideo(128)``), batches of
2 pairs of 2-frame 64x32 clips. Every comparison of a loaded checkpoint is
exact: a checkpoint carries fp32 values, and loading only moves them
between layouts.
"""

import argparse
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu.cli.train import build_models as j_build_models
from grl_tpu.engine.optim import SGD as JSGD
from grl_tpu.engine.train_step import init_train_state as j_init_train_state
from grl_tpu.engine.train_step import make_train_step as j_make_train_step
from grl_tpu.utils import convert_torch as jconvert
from grl_tpu.utils import serialization as jser
from grl_tpu_torch.cli.train import build_models
from grl_tpu_torch.engine import init_train_state, make_train_step
from grl_tpu_torch.utils import (AsyncCheckpointer, load_imagenet_resnet50, load_train_state,
                                 save_train_state, state_dict_from_jax, train_state_from_jax)
from grl_tpu_torch.utils import serialization

NUM_CLASSES = 5
ARGS = argparse.Namespace(arch2="siamese", bf16=False, use_flow=False, seed=0)


@functools.lru_cache(maxsize=1)
def jax_template():
    """grl_tpu's tiny models and their train-state template (built once)."""
    cnn, sia, unc = j_build_models(ARGS, tiny=True)
    return (cnn, sia, unc), j_init_train_state(jax.random.PRNGKey(0), cnn, sia, unc, NUM_CLASSES,
                                               num_feat=cnn.num_feat, optimizer=JSGD())


def port_state(seed=0):
    cnn, sia, unc = build_models(argparse.Namespace(arch2="siamese", seed=seed), tiny=True)
    return init_train_state(cnn, sia, unc, NUM_CLASSES, num_feat=cnn.num_feat, device="cpu")


def batch(seed):
    rng = np.random.RandomState(seed)
    return rng.randn(4, 2, 64, 32, 3).astype(np.float32), np.array([0, 0, 3, 3])


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def key_name(k):
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def assert_port_equals_tree(state, tree):
    """Every parameter, BN statistic, momentum buffer, lut and the step of
    ``state`` equal grl_tpu's ``tree``, exactly."""
    trace = tree["opt"][1].trace
    for key, module in state.models.items():
        want = state_dict_from_jax(tree["params"][key], tree["model_state"][key], module)
        for name, value in module.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                np.testing.assert_array_equal(value.numpy(), want[name].numpy(), err_msg=f"{key}.{name}")
        want_trace = state_dict_from_jax(trace[key], tree["model_state"][key], module)
        for name, p in module.named_parameters():
            np.testing.assert_array_equal(state.optimizer.state[p]["momentum_buffer"].numpy(),
                                          want_trace[name].numpy(), err_msg=f"momentum {key}.{name}")
    for k in ("corr", "uncorr"):
        np.testing.assert_array_equal(state.luts[k].numpy(), np.asarray(tree["luts"][k]))
    assert state.step == int(tree["step"])


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """grl_tpu's state after one step, saved by grl_tpu."""
    (cnn, sia, unc), ts = jax_template()
    step = j_make_train_step(cnn, sia, unc, JSGD(), donate=False)
    clips, ids = batch(1)
    ts, _ = step(ts, jnp.asarray(clips), jnp.asarray(ids, jnp.int32), 1e-3)
    path = str(tmp_path_factory.mktemp("jax") / "checkpoint.npz")
    jser.save_train_state(ts, {"epoch": 4, "best_top1": 0.25}, path)
    return np_tree(ts), path


def test_leaf_order_matches_grl_tpu_flatten():
    """The port's leaves: grl_tpu's flatten order, count, shapes and dtypes."""
    _, ts = jax_template()
    want = jax.tree_util.tree_flatten_with_path(ts)[0]
    got = serialization._entries(port_state())
    assert len(got) == len(want)
    for (path, value, layout), (jpath, jleaf) in zip(got, want):
        assert "/".join(path) == "/".join(key_name(k) for k in jpath)
        assert serialization._grl_shape(value, layout) == np.shape(jleaf), path
        assert serialization._np_dtype(value) == np.asarray(jleaf).dtype, path
    assert serialization.leaf_paths(port_state())[:2] == ["lr_mults/cnn/backbone/base/bn1/bias",
                                                         "lr_mults/cnn/backbone/base/bn1/scale"]


def test_grl_tpu_checkpoint_loads_into_the_port(jax_checkpoint):
    tree, path = jax_checkpoint
    state = port_state(seed=5)  # other weights than the checkpoint's
    extras = load_train_state(state, path)
    assert int(extras["epoch"]) == 4 and float(extras["best_top1"]) == 0.25
    bridged = train_state_from_jax(tree, port_state(seed=6))
    for key, module in state.models.items():
        for name, value in module.state_dict().items():
            if not name.endswith("num_batches_tracked"):
                torch.testing.assert_close(value, bridged.models[key].state_dict()[name], rtol=0, atol=0)
    assert_port_equals_tree(state, tree)


@pytest.mark.parametrize("writer", ["save_train_state", "AsyncCheckpointer"])
def test_port_checkpoint_loads_into_grl_tpu(tmp_path, writer):
    state = port_state()
    clips, ids = batch(2)
    state, _ = make_train_step(device="cpu")(state, torch.from_numpy(clips), ids, 1e-3)
    path = str(tmp_path / "checkpoint.npz")
    extras = {"epoch": 7, "best_top1": 0.5}
    if writer == "AsyncCheckpointer":
        ckpt = AsyncCheckpointer()
        ckpt.save(state, extras, path, is_best=True, best_name="checkpoint_best.npz")
        ckpt.wait()
        assert ckpt.last_bytes == (tmp_path / "checkpoint.npz").stat().st_size
        assert (tmp_path / "checkpoint_best.npz").read_bytes() == (tmp_path / "checkpoint.npz").read_bytes()
    else:
        save_train_state(state, extras, path)
    _, template = jax_template()
    tree, got = jser.load_train_state(template, path)
    assert int(got["epoch"]) == 7 and float(got["best_top1"]) == 0.5
    assert got["epoch"].dtype == np.int64 and got["best_top1"].dtype == np.float64
    assert_port_equals_tree(state, np_tree(tree))
    assert int(tree["step"]) == 1 and np.asarray(tree["step"]).dtype == np.int32
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 tree["lr_mults"], template["lr_mults"])


def test_async_snapshot_is_isolated_from_the_next_step(tmp_path, monkeypatch):
    """A step (and an in-place edit) taken before ``wait()`` does not leak
    into the file being written: the writer's pull is held back until
    both are done."""
    state = port_state()
    clips, ids = batch(3)
    step = make_train_step(device="cpu")
    state, _ = step(state, torch.from_numpy(clips), ids, 1e-3)
    want = [leaf.copy() for leaf in serialization.snapshot(state).leaves()]
    gate, pull = threading.Event(), serialization.Snapshot._pull
    monkeypatch.setattr(serialization.Snapshot, "_pull", lambda self: gate.wait(60) and pull(self))
    ckpt = AsyncCheckpointer()
    ckpt.save(state, {"epoch": 1}, str(tmp_path / "c.npz"))
    state, _ = step(state, torch.from_numpy(clips), ids, 1e-3)
    with torch.no_grad():
        for p in state.models.parameters():
            p.add_(1.0)
    gate.set()
    ckpt.wait()
    with np.load(tmp_path / "c.npz") as data:
        for i, leaf in enumerate(want):
            np.testing.assert_array_equal(data[f"leaf_{i:05d}"], leaf)
    assert ckpt.last_save_seconds >= 0 and ckpt.last_write_seconds > 0


def test_failed_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    state = port_state()
    path = str(tmp_path / "c.npz")
    ckpt = AsyncCheckpointer()
    ckpt.save(state, {"epoch": 1}, path)
    ckpt.wait()
    before = (tmp_path / "c.npz").read_bytes()

    def broken(f, **payload):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(serialization.np, "savez", broken)
    with torch.no_grad():
        next(state.models.parameters()).add_(1.0)
    ckpt.save(state, {"epoch": 2}, path)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    monkeypatch.undo()
    assert (tmp_path / "c.npz").read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["c.npz"]
    assert int(load_train_state(port_state(), path)["epoch"]) == 1


def _mismatch(kind, state):
    if kind == "classes":
        cnn, sia, unc = (state.models[k] for k in ("cnn", "siamese", "siamese_uncorr"))
        return init_train_state(cnn, sia, unc, NUM_CLASSES + 1, num_feat=cnn.num_feat, device="cpu")
    if kind == "dtype":
        state.luts = {k: v.double() for k, v in state.luts.items()}
    elif kind == "lr_mult":
        state.optimizer.param_groups[0]["lr_mult"] = 3.0
    elif kind == "width":
        cnn, sia, unc = build_models(argparse.Namespace(arch2="siamese", seed=0), tiny=True)
        sia = type(sia)(input_num=cnn.num_feat, output_num=256)
        return init_train_state(cnn, sia, unc, NUM_CLASSES, num_feat=cnn.num_feat, device="cpu")
    return state


@pytest.mark.parametrize("kind,match", [("classes", "shape mismatch"), ("dtype", "dtype mismatch"),
                                        ("lr_mult", "lr multiplier mismatch"), ("width", "shape mismatch")])
def test_load_rejects_a_mismatch(tmp_path, kind, match):
    path = str(tmp_path / "c.npz")
    save_train_state(port_state(), {"epoch": 0}, path)
    with pytest.raises(ValueError, match=match):
        load_train_state(_mismatch(kind, port_state()), path)


def test_load_rejects_another_leaf_count_and_a_missing_file(tmp_path):
    path = str(tmp_path / "c.npz")
    save_train_state(port_state(), {"epoch": 0}, path)
    with np.load(path) as data:
        payload = {k: data[k] for k in data.files if k != "leaf_00003"}
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="leaves"):
        load_train_state(port_state(), path)
    with pytest.raises(ValueError, match="No checkpoint"):
        load_train_state(port_state(), str(tmp_path / "absent.npz"))


def test_load_imagenet_resnet50_matches_grl_tpu():
    """A random torchvision-layout npz (fc and num_batches_tracked included)
    into the tiny trunk in both packages: equal leaf for leaf."""
    cnn = build_models(argparse.Namespace(arch2="siamese", seed=0), tiny=True)[0]
    trunk = cnn.backbone.base
    rng = np.random.RandomState(0)
    flat = {k: rng.randn(*v.shape).astype(np.float32) for k, v in trunk.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    flat.update({k: np.asarray(3, np.int64) for k in trunk.state_dict() if k.endswith("num_batches_tracked")})
    flat["fc.weight"], flat["fc.bias"] = rng.randn(10, 128).astype(np.float32), np.zeros(10, np.float32)

    _, ts = jax_template()
    base = lambda tree: np_tree(tree["cnn"]["backbone"]["base"])
    new_p, new_s = jconvert.load_imagenet_resnet50(base(ts["params"]), base(ts["model_state"]), flat)
    assert load_imagenet_resnet50(trunk, flat) is trunk
    want = state_dict_from_jax(new_p, new_s, trunk)
    for name, value in trunk.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(value, want[name], rtol=0, atol=0, msg=name)
            np.testing.assert_array_equal(value.numpy(), flat[name])
    assert int(trunk.bn1.num_batches_tracked) == 0

    with pytest.raises(KeyError, match="not in the trunk"):
        load_imagenet_resnet50(trunk, {"layer9.conv.weight": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_imagenet_resnet50(trunk, {"conv1.weight": np.zeros((4, 3, 5, 5), np.float32)})


def test_nested_checkpoint_helpers_cross_with_grl_tpu(tmp_path):
    """``save_checkpoint``/``load_checkpoint`` (flat npz of a nested dict)
    and the JSON helpers read each other's files in both packages."""
    tree = {"a": {"b": np.arange(6, dtype=np.float32).reshape(2, 3), "c": np.int32(4)}, "d": np.ones(2)}
    assert serialization.flatten_tree(tree).keys() == jser.flatten_tree(tree).keys()
    serialization.save_checkpoint(tree, str(tmp_path / "ours.npz"), is_best=True, best_name="best.npz")
    jser.save_checkpoint(tree, str(tmp_path / "theirs.npz"))
    for got in (jser.load_checkpoint(str(tmp_path / "best.npz")),
                serialization.load_checkpoint(str(tmp_path / "theirs.npz"))):
        jax.tree.map(np.testing.assert_array_equal, got, serialization.unflatten_tree(jser.flatten_tree(tree)))
    serialization.write_json({"x": [1, 2]}, str(tmp_path / "j" / "s.json"))
    assert jser.read_json(str(tmp_path / "j" / "s.json")) == {"x": [1, 2]}
    assert (tmp_path / "j" / "s.json").read_text() == '{\n    "x": [\n        1,\n        2\n    ]\n}'
