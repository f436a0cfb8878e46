"""Eval-mode parity of the port's model modules with grl_tpu's.

grl_tpu inits (with every BatchNorm's scale, bias, mean and var replaced by
seeded values, so the bridge's BN mapping is exercised) load into the port
through ``state_dict_from_jax`` with ``strict=True``; the same seeded
inputs then go through both. Tolerance 2e-4 abs/rel, as in
test_models_parity.py.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu import models as jm
from grl_tpu_torch import models as tm
from grl_tpu_torch.utils import state_dict_from_jax

B, T, H, W = 2, 3, 32, 16
WIDTH = 4  # trunk out channels 8 * WIDTH * 4 = 128
TOL = 2e-4
# a full-width ResNet-50 in train mode (53 BatchNorms on batch statistics
# over 6 frames): against an fp64 run of the same weights, the port's fp32
# embedding is 3.0e-4 off and grl_tpu's 2.3e-4, and the running variance of
# ``feat_bn`` (values to 36) 7e-5 and 2.9e-4 relative, so the two fp32
# runs are held to 1e-3 there; a unbiased/biased variance mix-up is 20 %
TRAIN_FULL_TOL = 1e-3


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def randomize_bn(params, state, seed):
    """Seeded BN scale/bias/mean/var (var > 0) in place of the identity init."""
    rng = np.random.RandomState(seed)

    def walk(p, s):
        if isinstance(s, dict) and "mean" in s and "var" in s:
            c = s["mean"].shape
            s["mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            s["var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            p["bias"] = rng.normal(0.0, 0.1, c).astype(np.float32)
            return
        for key in s if isinstance(s, dict) else ():
            walk(p[key], s[key])

    walk(params, state)
    return params, state


def jax_init(module, seed):
    params, state = module.init(jax.random.PRNGKey(seed))
    return randomize_bn(np_tree(params), np_tree(state), seed)


def bridged(torch_module, params, state):
    torch_module.load_state_dict(state_dict_from_jax(params, state, torch_module), strict=True)
    return torch_module.eval()


def clips(seed=0):
    return np.random.RandomState(seed).randn(B, T, H, W, 3).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def tiny_pair():
    return (jm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH),
            tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))


@pytest.mark.parametrize("last_stride", [1, 2])
def test_trunk(last_stride):
    jt = jm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=last_stride, width=WIDTH)
    tt = tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=last_stride, width=WIDTH)
    params, state = jax_init(jt, 1)
    x = clips()[:, 0]
    want, _ = jt.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = bridged(tt, params, state)(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1), want)


def test_gce_backbone():
    jt, tt = tiny_pair()
    jg, tg = jm.GCEBackbone(trunk=jt), tm.GCEBackbone(trunk=tt)
    params, state = jax_init(jg, 2)
    x = clips()
    want, _ = jg.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = bridged(tg, params, state)(torch.from_numpy(x))
    # grl_tpu: (t, b, h, w, c); the port: (b, t, c, h, w)
    for g, w in zip(got, want):
        close(g.permute(1, 0, 3, 4, 2), w)


def test_trl_block():
    ch, h, w = 32, 4, 2
    jb, tb = jm.TRLBlock(ch), tm.TRLBlock(ch)
    params, state = jax_init(jb, 3)
    rng = np.random.RandomState(3)
    xu, xc = (np.abs(rng.randn(T, B, h, w, ch)).astype(np.float32) for _ in range(2))
    (want_u, want_c), _ = jb.apply(params, state, (jnp.asarray(xu), jnp.asarray(xc)), training=False)
    to_port = lambda a: torch.from_numpy(a).permute(1, 0, 4, 2, 3)
    with torch.no_grad():
        got_u, got_c = bridged(tb, params, state)((to_port(xu), to_port(xc)))
    close(got_u, want_u)
    close(got_c, want_c)


def test_grl_model():
    jt, tt = tiny_pair()
    jg, tg = jm.GRLModel(trunk=jt), tm.GRLModel(trunk=tt)
    params, state = jax_init(jg, 4)
    x = clips()
    (want_u, want_c), _ = jg.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got_u, got_c = bridged(tg, params, state)(torch.from_numpy(x))
    assert tuple(got_u.shape) == (B, tg.num_feat) and tuple(got_c.shape) == (B, T, tg.num_feat)
    close(got_u, want_u)
    close(got_c, want_c)


def test_siamese_self_attention():
    chans = 64
    js, ts = jm.Siamese(input_num=chans, output_num=16), tm.Siamese(input_num=chans, output_num=16)
    params, state = jax_init(js, 5)
    x = np.random.RandomState(5).randn(4, T, chans).astype(np.float32)
    want, _ = js.self_attention(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = bridged(ts, params, state).self_attention(torch.from_numpy(x))
    close(got, want)


def test_bridge_rejects_mismatched_tree():
    js, ts = jm.Siamese(input_num=64, output_num=16), tm.Siamese(input_num=32, output_num=16)
    params, state = jax_init(js, 6)
    with pytest.raises(ValueError):
        state_dict_from_jax(params, state, ts)
    del params["featV"]
    with pytest.raises(KeyError):
        state_dict_from_jax(params, state, tm.Siamese(input_num=64, output_num=16))


def test_fresh_init_follows_grl_tpu_distributions():
    model = tm.create("siamese", device="cpu", seed=0, input_num=256, output_num=64)
    again = tm.create("siamese", device="cpu", seed=0, input_num=256, output_num=64)
    for (k, v), v2 in zip(model.state_dict().items(), again.state_dict().values()):
        assert torch.equal(v, v2), k  # same seed, same weights
    w = model.featQ.weight.detach()
    bound = np.sqrt(6.0 / 64)  # kaiming-uniform on fan-out (64)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
    assert float(model.featQ.bias.detach().abs().max()) == 0.0
    assert abs(float(model.classifierlinear.weight.detach().std()) - 0.001) < 3e-4
    trunk = tm.ResNetTrunk(layers=(1, 1, 1, 1), width=8)
    tm.init_weights(trunk, torch.Generator().manual_seed(1))
    conv = trunk.layer1[0].conv2.weight.detach()  # 3x3, 8 -> 8: std sqrt(2 / (9 * 8))
    assert abs(float(conv.std()) - np.sqrt(2.0 / 72)) < 0.03


def test_create_names_and_rejects_unknown():
    assert tm.names() == jm.names() == ["resnet50", "resnet50_grl", "siamese", "siamese_video", "two_stream"]
    with pytest.raises(KeyError):
        tm.create("nope", device="cpu")


def flow_clips(seed=0):
    return np.random.RandomState(seed).randn(B, T, H, W, 6).astype(np.float32)


def close_bn_stats(torch_module, params, new_state, tol=TOL):
    """The port's BN running statistics after a train-mode forward equal
    grl_tpu's new state."""
    want = state_dict_from_jax(params, np_tree(new_state), torch_module)
    got = torch_module.state_dict()
    keys = [k for k in got if k.endswith(("running_mean", "running_var"))]
    assert keys
    for k in keys:
        close(got[k], want[k].numpy(), tol)


def test_six_channel_trunk_and_grl_model():
    """``in_channels=6`` (the ``--use-flow`` trunk): conv1 takes RGB | flow."""
    jt = jm.ResNetTrunk(layers=(1, 1, 1, 1), width=WIDTH, in_channels=6)
    tt = tm.ResNetTrunk(layers=(1, 1, 1, 1), width=WIDTH, in_channels=6)
    assert tuple(tt.conv1.weight.shape) == (WIDTH, 6, 7, 7)
    params, state = jax_init(jt, 6)
    x = flow_clips()[:, 0]
    want, _ = jt.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got = bridged(tt, params, state)(torch.from_numpy(x).permute(0, 3, 1, 2))
    close(got.permute(0, 2, 3, 1), want)

    jg = jm.GRLModel(trunk=jm.ResNetTrunk(layers=(1, 1, 1, 1), width=WIDTH, in_channels=6))
    tg = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), width=WIDTH, in_channels=6))
    params, state = jax_init(jg, 7)
    x = flow_clips(1)
    (want_u, want_c), _ = jg.apply(params, state, jnp.asarray(x), training=False)
    with torch.no_grad():
        got_u, got_c = bridged(tg, params, state)(torch.from_numpy(x))
    close(got_u, want_u)
    close(got_c, want_c)


@functools.lru_cache(maxsize=None)
def _resnet50_baseline_init():
    # one grl_tpu init (15 s of eager jax.random) serves num_features 0 and
    # 16: the 0 variant's tree is the 16 variant's less feat / feat_bn
    return jax_init(jm.ResNetBaseline(num_features=16), 8)


def baseline_pair(kind):
    """(grl_tpu module, port module, params, state, clips) for one case."""
    if kind == "two_stream":
        jmod = jm.two_stream_tiny(num_features=16)
        return (jmod, tm.two_stream_tiny(num_features=16), *jax_init(jmod, 8), flow_clips(2))
    nf = int(kind.split("_")[1])
    params, state = copy.deepcopy(_resnet50_baseline_init())
    return jm.ResNetBaseline(num_features=nf), tm.ResNetBaseline(num_features=nf), params, state, clips(2)


@pytest.mark.parametrize("kind", ["resnet50_0", "resnet50_16", "two_stream"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_per_frame_baselines(kind, training):
    """``ResNetBaseline`` (full-width trunk, ``num_features`` 0 and 16) and
    ``two_stream_tiny``: both heads, and in train mode the BN running
    statistics."""
    jmod, tmod, params, state, x = baseline_pair(kind)
    (want_e, want_r), new_state = jmod.apply(params, state, jnp.asarray(x), training=training)
    port = bridged(tmod, params, state).train(training)
    with torch.no_grad():
        got_e, got_r = port(torch.from_numpy(x))
    assert got_e.shape == want_e.shape and got_r.shape == want_r.shape
    if kind == "resnet50_0":
        assert got_e is got_r
    tol = TRAIN_FULL_TOL if training and kind != "two_stream" else TOL
    close(got_e, want_e, tol)
    close(got_r, want_r, tol)
    if training:
        close_bn_stats(port, params, new_state, tol)


def test_two_stream_rejects_three_channels():
    model = tm.two_stream_tiny().eval()
    with pytest.raises(ValueError, match="6 channels"):
        model(torch.from_numpy(clips()))
