"""``grl_tpu_torch/utils/convert_torch.py`` against grl_tpu's converters.

The repo ships no reference checkpoint, so the tests build state
dicts under the reference's key names: the tiny GRL model's keys mapped
back through ``GRL_ALIASES`` (``backbone.base.0``,
``temporal_learning_block.forward_f1.0`` ...) behind ``nn.DataParallel``'s
``module.`` prefix, with random numpy values. Every converter must give
grl_tpu's trees exactly; the GRL model loaded through
``load_grl_checkpoint`` then ``state_dict_from_jax`` gives grl_tpu's
eval-mode forward on the same converted parameters within 2e-4 (the
tolerance of ``tests/test_torch_models.py``).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu import models as jm
from grl_tpu.utils import convert_torch as J
from grl_tpu_torch import models as tm
from grl_tpu_torch.utils import convert_torch as T
from grl_tpu_torch.utils import state_dict_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)


def leaves(tree, prefix=""):
    """{path: array} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(a, b):
    a, b = leaves(a), leaves(b)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def reference_key(key):
    """A port (and grl_tpu) key under the reference model's name for it."""
    for src, dst in sorted(T.GRL_ALIASES.items(), key=lambda kv: -len(kv[1])):
        if key == dst or key.startswith(dst + "."):
            return src + key[len(dst):]
    return key


def tiny_cnn():
    return tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), width=4))


@pytest.fixture(scope="module")
def reference_flat():
    """A reference-named, DataParallel-prefixed GRL state dict of random
    numpy values (BN variances positive)."""
    rng = np.random.RandomState(0)
    flat = {}
    for key, value in tiny_cnn().state_dict().items():
        if key.endswith("num_batches_tracked"):
            v = np.asarray(7, np.int64)
        elif key.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        else:
            v = (0.1 * rng.randn(*value.shape)).astype(np.float32)
        flat["module." + reference_key(key)] = v
    assert any(k.startswith("module.backbone.base.4.") for k in flat)
    assert any(k.startswith("module.temporal_learning_block.forward_f1.0.") for k in flat)
    return flat


def jax_grl_init():
    cnn = jm.GRLModel(trunk=jm.ResNetTrunk(layers=(1, 1, 1, 1), width=4))
    params, state = cnn.init(jax.random.PRNGKey(0))
    return cnn, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def test_aliases_equal_grl_tpu_s():
    assert T.GRL_ALIASES == J.GRL_ALIASES


def test_torch_to_pytree_and_back_equal_grl_tpu(reference_flat):
    """``torch_to_pytree`` (aliases, the prefix, every layout rule) and its
    inverse ``pytree_to_torch_state`` give grl_tpu's values; the inverse
    restores the reference dict (counters as zeros)."""
    ours = T.torch_to_pytree(reference_flat, aliases=T.GRL_ALIASES)
    theirs = J.torch_to_pytree(reference_flat, aliases=J.GRL_ALIASES)
    for a, b in zip(ours, theirs):
        assert_trees_equal(a, b)
    keys = [k[len("module."):] for k in reference_flat]
    back = T.pytree_to_torch_state(*ours, keys, aliases=T.GRL_ALIASES)
    want = J.pytree_to_torch_state(*theirs, keys, aliases=J.GRL_ALIASES)
    assert sorted(back) == sorted(want) == sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        expect = 0 if k.endswith("num_batches_tracked") else reference_flat["module." + k]
        np.testing.assert_array_equal(back[k], expect, err_msg=k)
    with pytest.raises(ValueError, match="Unhandled"):
        T.torch_to_pytree({"a.b.unknown": np.zeros(2)})
    with pytest.raises(ValueError, match="Unhandled"):
        T.torch_to_pytree({"conv.weight": np.zeros((2, 2, 2))})


def test_merge_pytree_equals_grl_tpu_and_refuses_what_does_not_fit():
    base = {"a": {"kernel": np.zeros((2, 3), np.float32), "bias": np.zeros(3, np.float32)}, "b": np.ones(4)}
    overlay = {"a": {"kernel": np.arange(6.0).reshape(2, 3)}}
    assert_trees_equal(T.merge_pytree(base, overlay), J.merge_pytree(base, overlay))
    assert T.merge_pytree(base, overlay)["a"]["kernel"].dtype == np.float32
    for fn in (T.merge_pytree, J.merge_pytree):
        with pytest.raises(KeyError, match="not present in target tree"):
            fn(base, {"c": np.zeros(1)})
        with pytest.raises(ValueError, match="Shape mismatch"):
            fn(base, {"a": {"bias": np.zeros(4)}})


def test_load_grl_checkpoint_into_the_port_gives_grl_tpu_s_forward(reference_flat):
    """``load_grl_checkpoint`` onto the GRL model's trees equals grl_tpu's;
    the port's ``GRLModel`` loaded from them (``state_dict_from_jax``) and
    grl_tpu's on the same trees describe the same clips alike (eval mode)."""
    jcnn, params, state = jax_grl_init()
    ours = T.load_grl_checkpoint(params, state, reference_flat)
    theirs = J.load_grl_checkpoint(params, state, reference_flat)
    for a, b in zip(ours, theirs):
        assert_trees_equal(a, b)
    cnn = tiny_cnn()
    cnn.load_state_dict(state_dict_from_jax(*ours, cnn), strict=True)
    cnn.eval()
    conv1 = cnn.backbone.base.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(conv1, reference_flat["module.backbone.base.0.weight"])
    x = np.random.RandomState(1).randn(2, 3, 64, 32, 3).astype(np.float32)
    (want_u, want_c), _ = jcnn.apply(*theirs, jnp.asarray(x), training=False)
    with torch.no_grad():
        got_u, got_c = cnn(torch.from_numpy(x))
    np.testing.assert_allclose(got_u.numpy(), np.asarray(want_u), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)


def test_main_round_trips_a_torch_save(tmp_path, monkeypatch, reference_flat, capsys):
    """``python -m grl_tpu_torch.utils.convert_torch --src X.pth.tar --out
    X.npz`` flattens a ``torch.save``d ``{"state_dict": ...}`` as grl_tpu's
    does, every value unchanged; a bare state dict too."""
    src = tmp_path / "model.pth.tar"
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in reference_flat.items()}, "epoch": 3}, src)
    for name, fn in (("ours", T._main), ("theirs", J._main)):
        monkeypatch.setattr(sys, "argv", ["convert_torch", "--src", str(src), "--out", str(tmp_path / f"{name}.npz")])
        fn()
    assert f"wrote {len(reference_flat)} arrays" in capsys.readouterr().out
    ours, theirs = np.load(tmp_path / "ours.npz"), np.load(tmp_path / "theirs.npz")
    assert sorted(ours.files) == sorted(theirs.files) == sorted(reference_flat)
    for k in ours.files:
        np.testing.assert_array_equal(ours[k], reference_flat[k], err_msg=k)
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    bare = tmp_path / "bare.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in reference_flat.items()}, bare)
    monkeypatch.setattr(sys, "argv", ["convert_torch", "--src", str(bare), "--out", str(tmp_path / "bare.npz")])
    T._main()
    assert sorted(np.load(tmp_path / "bare.npz").files) == sorted(reference_flat)


def test_imagenet_loader_is_found_in_convert_torch():
    from grl_tpu_torch.utils import load_imagenet_resnet50
    from grl_tpu_torch.utils.convert_torch import load_imagenet_resnet50 as again

    assert again is load_imagenet_resnet50
    with pytest.raises(AttributeError):
        T.not_a_converter  # noqa: B018
