"""bf16 ``compute_dtype`` in the port against grl_tpu's, on the CPU.

grl_tpu inits (BN scale, bias, mean and var seeded, as in
``test_torch_models.py``) load into the port's modules through the weight
bridge; grl_tpu runs with ``compute_dtype=jnp.bfloat16`` and the port with
``compute_dtype=torch.bfloat16`` on the same seeded inputs.

- **dtypes, exactly**: every module's outputs carry grl_tpu's dtypes (bf16
  activations, the fp32 Siamese pooling, the fp32 descriptor).
- **values**: a bf16 ulp is 2⁻⁸ of a value's magnitude; each bound is a
  number of ulps of the output's largest element. The port rounds where
  grl_tpu does (the trunk and GCE are bit-equal in eval mode, held to 1
  ulp; self-attention's fp32 pooling to 1e-3), and the TRL's and
  GRLModel's eval bound is 4 ulps: grl_tpu's eval-mode TRL runs a ``lax.scan``, which
  XLA fuses with intermediates kept in fp32, and differs from its own
  unrolled form (to which the port's loop is bit-equal) by about an ulp.
  Train mode takes 16 ulps: BatchNorm normalizes over batch statistics
  that two frameworks sum in another order, and an fp32 difference that
  flips one bf16 rounding moves the flipped element by an ulp, which the
  next layers carry. BN running statistics (fp32 sums of bf16
  activations) within 8 ulps of each statistic's largest element.
  The measured maxima are noted beside the bounds.
- **the port's bf16 descriptor against its fp32 descriptor** of the same
  weights: per-row cosine ≥ 0.999 on each 2048-d segment (measured
  0.99998), so that a wrong cast both packages share cannot hide.
- **the L2 norms** bit-equal to grl_tpu's in bf16.
- **two chained training steps**, each of the port's from grl_tpu's state
  before it, held leaf by leaf: the update's cosine and norm ratio at the
  median leaf and at every leaf but those whose bf16 update is rounding,
  conv1's read on its own, the loss terms, BN statistics and luts, each
  limit beside its readings; and the step's mechanics exactly: fp32
  parameters, optimizer state, BN statistics and luts; unit lut rows.
- **gradients**: the backward pass through the casts, leaf by leaf, on a
  random functional of the eval-mode outputs of GRLModel and Siamese.
- **the CLIs** with ``--bf16`` on ``--device cpu --tiny`` over the synthetic
  catalog, and the precision policy (both TF32 flags and cuBLAS's bf16
  reductions off after each CLI's ``main``, though set on before; the
  flags are restored after each call).
"""

import argparse
import functools
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu import models as jm
from grl_tpu.cli import train as j_train
from grl_tpu.engine.evaluator import make_descriptor_fn as j_descriptor
from grl_tpu.engine.optim import SGD as JSGD
from grl_tpu.engine.train_step import init_train_state as j_init_train_state
from grl_tpu.engine.train_step import make_train_step as j_make_train_step
from grl_tpu.utils import serialization as jser
from grl_tpu_torch import models as tm
from grl_tpu_torch import precision_flags, set_precision_flags
from grl_tpu_torch.cli import evaluate as t_eval
from grl_tpu_torch.cli import extract as t_extract
from grl_tpu_torch.cli import train as t_train
from grl_tpu_torch.data import SyntheticVideoReID, get_data
from grl_tpu_torch.engine import Evaluator, init_train_state, make_descriptor_fn, make_train_step
from grl_tpu_torch.utils import load_train_state, serialization, state_dict_from_jax, train_state_from_jax
from test_torch_models import randomize_bn

JB, TB = jnp.bfloat16, torch.bfloat16
ULP = 2.0 ** -8
# bounds in ulps of the output's largest element, per module and mode:
# in eval mode the trunk and the GCE are bit-equal (a flipped rounding
# anywhere reads at most 1); train mode's readings move with the CPU
# threads that sum the batch statistics (GRLModel: 0 with 1 or 8 threads,
# 10.8 with 2)
MODULE_ULPS = {("trunk", "eval"): 1, ("gce", "eval"): 1, ("trl", "eval"): 4, ("grl", "eval"): 4,
               ("trunk", "train"): 16, ("gce", "train"): 16, ("trl", "train"): 16, ("grl", "train"): 16}
EVAL_ULPS = 4  # the descriptor: TRL's reading
SELF_ATTENTION_ULPS = 1e-3  # fp32 products and pooling: an fp32 ulp is 2⁻¹⁵ of these
STAT_ULPS = 8  # fp32 statistics of bf16 activations
COSINE_MIN = 0.999
# a bf16 step against grl_tpu's from the same state, each limit beside the
# readings of the two steps: loss terms relative (0.064, 0.035); the median
# parameter leaf's update cosine (0.894, 0.949) and norm ratio (1.043,
# 1.000); conv1's cosine (0.763, 0.912); every leaf's cosine (lowest
# 0.668, 0.720) and norm ratio (farthest 1.649, 0.680) but
# ROUNDING_LEAVES; a zero update reads cosine 0 and ratio 0; BN
# statistics in shares of each one's largest element (0.024, 0.032: the
# BN-neck's variance of nearly alike features); luts max abs (0.049, 0.024)
STEP_TOL = {"loss": 0.1, "cosine": 0.8, "ratio": (0.8, 1.25), "conv1_cosine": 0.5,
            "leaf_cosine": 0.5, "leaf_ratio": (0.5, 2.0), "bn": 0.06, "lut": 0.1}
# leaves whose bf16 update is rounding: a bias in front of a train-mode BN
# through a linear map (zero in exact arithmetic), the mask's 1-channel BN
# bias (one sum over every pixel) and the 2-way classifier's bias (two
# values summing to zero); grl_tpu's own jitted and op-by-op bf16 steps
# put them 1.6-8.3 apart (relative L2)
ROUNDING_LEAVES = ("cnn.backbone.glo_fc.0.bias", "cnn.backbone.corr_atte.1.bias", "cnn.backbone.corr_atte.6.bias",
                   "siamese.featQ.bias", "siamese.featK.bias", "siamese.classifierlinear.bias")
# the gradient of a random functional, port against grl_tpu in bf16,
# relative L2 per leaf: the median leaf and the worst, beside the readings
# (GRL: 0.0496, 0.223; Siamese: 0.00272, 0.0174)
GRAD_TOL = {"grl": {"median": 0.1, "leaf": 0.5}, "siamese": {"median": 0.01, "leaf": 0.05}}
WIDTH = 4
EVAL_SHAPE = (2, 3, 32, 16)   # b, t, h, w: test_models_parity.py's
TRAIN_SHAPE = (4, 2, 64, 32)  # the port's train tests'
# measured max |port − grl_tpu| in ulps of the output's largest element,
# with these seeds: eval trunk 0, GCE 0, TRL 1.6, GRLModel 1.45,
# self-attention 2.8e-5, descriptor 1.3; train trunk 0, GCE 5.0 (its BN
# statistics 0.26, the others' 0), TRL 0, GRLModel 0 (8 threads). A q·k
# product rounded to bf16 in the Siamese reads 0.071 on self-attention


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def trunks(cd_j, cd_t):
    return (jm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH, compute_dtype=cd_j),
            tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH, compute_dtype=cd_t))


def bridged(module, params, state, training):
    module.load_state_dict(state_dict_from_jax(params, state, module), strict=True)
    return module.train(training)


def port_dtype(dtype):
    return {jnp.dtype(JB): TB, jnp.dtype(jnp.float32): torch.float32}[jnp.dtype(dtype)]


def assert_close_in_ulps(got, want, ulps, what):
    assert got.dtype == port_dtype(want.dtype), f"{what}: dtype {got.dtype}, grl_tpu {want.dtype}"
    g, w = f32(got), f32(want)
    assert g.shape == w.shape, what
    scale = float(np.abs(w).max())
    err = float(np.abs(g - w).max())
    assert err <= ulps * ULP * scale, f"{what}: {err / (ULP * scale):.2f} ulps of the largest element"


def module_case(name, training):
    """(grl_tpu outputs, port outputs in grl_tpu's layout, grl_tpu's new
    state tree, the port module) for one module."""
    b, t, h, w = TRAIN_SHAPE if training else EVAL_SHAPE
    rng = np.random.RandomState(7)
    clips = rng.randn(b, t, h, w, 3).astype(np.float32)
    jt, tt = trunks(JB, TB)
    if name == "trunk":
        jmod, tmod = jt, tt
        x_j, x_t = jnp.asarray(clips[:, 0]), torch.from_numpy(clips[:, 0]).permute(0, 3, 1, 2)
        layout = lambda outs: [outs.permute(0, 2, 3, 1)]
    elif name == "gce":
        jmod, tmod = jm.GCEBackbone(trunk=jt, compute_dtype=JB), tm.GCEBackbone(trunk=tt, compute_dtype=TB)
        x_j, x_t = jnp.asarray(clips), torch.from_numpy(clips)
        layout = lambda outs: [o.permute(1, 0, 3, 4, 2) for o in outs]
    elif name == "trl":
        ch, fh, fw = 32, 4, 2
        jmod, tmod = jm.TRLBlock(ch, compute_dtype=JB), tm.TRLBlock(ch, compute_dtype=TB)
        xu, xc = (jnp.asarray(np.abs(rng.randn(t, b, fh, fw, ch)), JB) for _ in range(2))
        to_port = lambda a: torch.from_numpy(f32(a)).to(TB).permute(1, 0, 4, 2, 3)
        x_j, x_t = (xu, xc), (to_port(xu), to_port(xc))
        layout = list
    elif name == "grl":
        jmod, tmod = jm.GRLModel(trunk=jt, compute_dtype=JB), tm.GRLModel(trunk=tt, compute_dtype=TB)
        x_j, x_t = jnp.asarray(clips), torch.from_numpy(clips)
        layout = list
    else:
        raise KeyError(name)
    params, state = randomize_bn(*np_tree(jmod.init(jax.random.PRNGKey(3))), 3)
    want, new_state = jmod.apply(params, state, x_j, training=training)
    with torch.set_grad_enabled(training):
        out = bridged(tmod, params, state, training)(x_t)
    return [want] if name == "trunk" else list(want), layout(out), (params, new_state), tmod


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", ["trunk", "gce", "trl", "grl"])
def test_module_matches_grl_tpu_in_bf16(name, training):
    want, got, (params, new_state), tmod = module_case(name, training)
    assert len(got) == len(want)
    ulps = MODULE_ULPS[name, "train" if training else "eval"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_in_ulps(g, w, ulps, f"{name} output {i}")
    if training:  # fp32 running statistics, advanced as grl_tpu's
        expect = state_dict_from_jax(np_tree(params), np_tree(new_state), tmod)
        for key, value in tmod.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                assert value.dtype == torch.float32, key
                err = float((value - expect[key]).abs().max())
                assert err <= STAT_ULPS * ULP * float(expect[key].abs().max()), f"{key}: {err}"
        for p in tmod.parameters():
            assert p.dtype == torch.float32


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_sigmoid_rounds_and_differentiates_as_grl_tpu(dtype):
    """``nn.sigmoid`` against ``jax.nn.sigmoid``: in bf16 the same values bit
    for bit (fp32: within an fp32 ulp, the two libraries' ``exp``), and
    the same gradient, finite where ``exp(-x)`` overflows."""
    from grl_tpu_torch.nn import sigmoid

    x = (np.random.RandomState(9).randn(4096) * 8).astype(np.float32)
    x[:4] = [-200.0, -90.0, 90.0, 0.0]
    xj = jnp.asarray(x, dtype)
    want = jax.nn.sigmoid(xj)
    want_grad = jax.grad(lambda a: jnp.sum(jax.nn.sigmoid(a).astype(jnp.float32) * jnp.arange(4096.0)))(xj)
    xt = torch.from_numpy(f32(xj)).to(getattr(torch, dtype)).requires_grad_()
    got = sigmoid(xt)
    (got.float() * torch.arange(4096.0)).sum().backward()
    np.testing.assert_allclose(f32(got), f32(want), rtol=0 if dtype == "bfloat16" else 2.0 ** -22, atol=0)
    assert np.isfinite(f32(xt.grad)).all()
    np.testing.assert_allclose(f32(xt.grad), f32(want_grad), rtol=ULP if dtype == "bfloat16" else 1e-6, atol=0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ["l2_normalize", "l2_unit"])
def test_norms_round_as_grl_tpu(name, dtype):
    """The L2 norms compute in fp32 and cast back: on the same values the
    port's and grl_tpu's agree bit for bit in bf16 (a norm taken in bf16
    would round the divisor first), and within 4 fp32 ulps in fp32
    (measured 2.5e-7 relative)."""
    from grl_tpu.nn import functional as jf
    from grl_tpu_torch import nn as tnn

    x = jnp.asarray(np.random.RandomState(15).randn(64, 96).astype(np.float32) * 3, dtype)
    want = getattr(jf, name)(x, axis=1)
    got = getattr(tnn, name)(torch.from_numpy(f32(x)).to(getattr(torch, dtype)), dim=1)
    assert got.dtype == port_dtype(want.dtype)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0 if dtype == "bfloat16" else 2.0 ** -21, atol=0)


@functools.lru_cache(maxsize=None)
def descriptor_case():
    """grl_tpu's bf16 GRL + Siamese (bridged into the port at bf16 and at
    fp32) and one batch of uint8 clips."""
    b, t, h, w = EVAL_SHAPE
    jt, _ = trunks(JB, None)
    jcnn = jm.GRLModel(trunk=jt, compute_dtype=JB)
    jsia = jm.Siamese(input_num=jcnn.num_feat, output_num=16, compute_dtype=JB)
    cp, cs = randomize_bn(*np_tree(jcnn.init(jax.random.PRNGKey(4))), 4)
    sp, ss = randomize_bn(*np_tree(jsia.init(jax.random.PRNGKey(5))), 5)
    ported = {}
    for cd in (TB, None):
        cnn = tm.GRLModel(trunk=trunks(None, cd)[1], compute_dtype=cd)
        sia = tm.Siamese(input_num=cnn.num_feat, output_num=16, compute_dtype=cd)
        ported[cd] = bridged(cnn, cp, cs, False), bridged(sia, sp, ss, False)
    u8 = np.random.RandomState(6).randint(0, 256, (b, t, h, w, 3)).astype(np.uint8)
    return (jcnn, jsia, cp, cs, sp, ss), ported, u8


def test_self_attention_pools_in_fp32_as_grl_tpu():
    (_, jsia, _, _, sp, ss), ported, _ = descriptor_case()
    x = np.random.RandomState(8).randn(4, 3, jsia.input_num).astype(np.float32)
    want, _ = jsia.self_attention(sp, ss, jnp.asarray(x, JB), training=False)
    with torch.no_grad():
        got = ported[TB][1].self_attention(torch.from_numpy(x).to(TB))
    assert want.dtype == jnp.float32
    assert_close_in_ulps(got, want, SELF_ATTENTION_ULPS, "self_attention")


def test_descriptor_is_fp32_and_matches_grl_tpu():
    (jcnn, jsia, cp, cs, sp, ss), ported, u8 = descriptor_case()
    want = j_descriptor(jcnn, jsia)(cp, cs, sp, ss, jnp.asarray(u8))
    with torch.no_grad():
        got = make_descriptor_fn(*ported[TB])(torch.from_numpy(u8))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert_close_in_ulps(got, want, EVAL_ULPS, "descriptor")


def test_bf16_descriptor_agrees_with_the_port_s_fp32_descriptor():
    _, ported, u8 = descriptor_case()
    with torch.no_grad():
        bf16 = make_descriptor_fn(*ported[TB])(torch.from_numpy(u8))
        fp32 = make_descriptor_fn(*ported[None])(torch.from_numpy(u8))
    c = ported[None][0].num_feat
    for i in range(3):
        seg = slice(i * c, (i + 1) * c)
        cos = torch.nn.functional.cosine_similarity(bf16[:, seg], fp32[:, seg], dim=1)
        assert float(cos.min()) >= COSINE_MIN, f"segment {i}: cosine {float(cos.min())}"
    assert float((bf16 - fp32).abs().max()) > 0  # the two really are different precisions


# ---- the training step ----

NUM_CLASSES = 3
LR = (1e-3, 2e-3)


def step_models(pkg, cd):
    mods, trunk = (jm, trunks(cd, None)[0]) if pkg == "jax" else (tm, trunks(None, cd)[1])
    cnn = mods.GRLModel(trunk=trunk, compute_dtype=cd)
    return (cnn, mods.Siamese(input_num=cnn.num_feat, output_num=16, compute_dtype=cd),
            mods.SiameseVideo(input_num=cnn.num_feat, compute_dtype=cd))


def step_batches():
    rng = np.random.RandomState(11)
    b, t, h, w = TRAIN_SHAPE
    clips = [rng.randn(b, t, h, w, 3).astype(np.float32) for _ in LR]
    return list(zip(clips, [np.array([0, 0, 1, 1]), np.array([2, 2, 0, 0])], LR))


def jax_steps():
    """grl_tpu's init (seeded BN, unit luts) and its states after each of
    two bf16 steps, with the metrics."""
    cnn, sia, unc = step_models("jax", JB)
    ts = np_tree(j_init_train_state(jax.random.PRNGKey(0), cnn, sia, unc, NUM_CLASSES, num_feat=cnn.num_feat))
    for i, key in enumerate(("cnn", "siamese", "siamese_uncorr")):
        randomize_bn(ts["params"][key], ts["model_state"][key], 20 + i)
    rng = np.random.RandomState(1)
    for k in ("corr", "uncorr"):
        lut = rng.randn(NUM_CLASSES, cnn.num_feat).astype(np.float32)
        ts["luts"][k] = lut / np.linalg.norm(lut, axis=1, keepdims=True)
    step = j_make_train_step(cnn, sia, unc, JSGD(), donate=False)
    states, metrics = [ts], []
    for clips, targets, lr in step_batches():
        new, m = step(jax.tree.map(jnp.asarray, states[-1]), jnp.asarray(clips), jnp.asarray(targets, jnp.int32), lr)
        states.append(np_tree(new))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


def flat_tree(tree, modules):
    """Parameters (by port name) and BN statistics of a grl_tpu state tree."""
    out = {}
    for key, module in modules.items():
        for name, v in state_dict_from_jax(tree["params"][key], tree["model_state"][key], module).items():
            out[f"{key}.{name}"] = v.double()
    return out


def leaf_updates(a, a0, b, b0):
    """Per parameter leaf: (cosine, norm ratio) of update ``a - a0`` against
    ``b - b0`` (flat dicts); a zero update reads cosine 0, ratio 0."""
    out = {}
    for k in b:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        ua, ub = (a[k] - a0[k]).flatten(), (b[k] - b0[k]).flatten()
        if float(ub.norm()) > 0:
            out[k] = (float(ua @ ub / (ua.norm() * ub.norm()).clamp_min(1e-300)), float(ua.norm() / ub.norm()))
    return out


def test_two_bf16_train_steps_against_grl_tpu():
    """Each of the port's two steps starts from grl_tpu's bf16 state before
    it (weights, BN statistics, luts, and for the second step the first's
    momentum) and is held to grl_tpu's step leaf by leaf. At these widths a
    bf16 step's rounding decides the next: the port's second step from its
    own first step is as far from grl_tpu's as grl_tpu's bf16 chain is from
    its fp32 chain (median leaf cosine 0.26 against 0.32), so the chain runs
    through grl_tpu's states."""
    j16, m16 = jax_steps()
    state = init_train_state(*step_models("port", TB), NUM_CLASSES, num_feat=8 * WIDTH * 4, device="cpu")
    modules = dict(state.models.items())
    step = make_train_step(device="cpu")
    for i, (clips, targets, lr) in enumerate(step_batches()):
        state = train_state_from_jax(j16[i], state)
        state, m = step(state, torch.from_numpy(clips), targets, lr)
        port = {f"{k}.{n}": v.double() for k, mod in modules.items() for n, v in mod.state_dict().items()}
        m = {k: float(v) for k, v in m.items()}
        assert all(np.isfinite(v) for v in m.values()), m
        # the mechanics: fp32 parameters, optimizer state, statistics, luts
        for p in state.models.parameters():
            assert p.dtype == torch.float32
            assert state.optimizer.state[p]["momentum_buffer"].dtype == torch.float32
        for k, lut in state.luts.items():
            assert lut.dtype == torch.float32, k
            norms = lut.norm(dim=1)
            torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=1e-5)
        at = f"step {i + 1}"
        loss = max(abs(m[k] - m16[i][k]) / abs(m16[i][k]) for k in m16[i] if k.startswith("loss"))
        assert loss <= STEP_TOL["loss"], f"{at}: loss terms {loss:.4g}"
        want, want0 = flat_tree(j16[i + 1], modules), flat_tree(j16[i], modules)
        leaves = {k: v for k, v in leaf_updates(port, want0, want, want0).items() if k not in ROUNDING_LEAVES}
        cos, ratio = (float(np.median([v[j] for v in leaves.values()])) for j in (0, 1))
        worst = min(leaves, key=lambda k: leaves[k][0])
        far = max(leaves, key=lambda k: abs(np.log(leaves[k][1])))
        conv1 = leaves["cnn.backbone.base.conv1.weight"]
        readings = (f"{at}: median leaf cosine {cos:.3f}, norm ratio {ratio:.3f}; conv1 {conv1}; "
                    f"lowest cosine {worst} {leaves[worst]}; farthest ratio {far} {leaves[far]}")
        assert cos >= STEP_TOL["cosine"] and STEP_TOL["ratio"][0] <= ratio <= STEP_TOL["ratio"][1], readings
        assert conv1[0] >= STEP_TOL["conv1_cosine"], readings
        assert leaves[worst][0] >= STEP_TOL["leaf_cosine"], readings
        assert STEP_TOL["leaf_ratio"][0] <= leaves[far][1] <= STEP_TOL["leaf_ratio"][1], readings
        for k in want:
            if k.endswith(("running_mean", "running_var")):
                err = float((port[k] - want[k]).abs().max())
                assert err <= STEP_TOL["bn"] * float(want[k].abs().max()), f"{at}: {k} {err:.4g}"
        for k, lut in state.luts.items():
            err = float((lut.double() - torch.from_numpy(np.array(j16[i + 1]["luts"][k])).double()).abs().max())
            assert err <= STEP_TOL["lut"], f"{at}: lut {k} {err:.4g}"
    assert state.step == 2


def head_case(name):
    """(grl_tpu module, port module bridged in eval mode, params, state,
    grl_tpu input, port input), bf16, for the gradient test."""
    rng = np.random.RandomState(12)
    if name == "grl":
        jt, tt = trunks(JB, TB)
        jmod, tmod = jm.GRLModel(trunk=jt, compute_dtype=JB), tm.GRLModel(trunk=tt, compute_dtype=TB)
        x = rng.randn(*TRAIN_SHAPE, 3).astype(np.float32)
        x_j, x_t = jnp.asarray(x), torch.from_numpy(x)
    else:
        c = 8 * WIDTH * 4
        jmod = jm.Siamese(input_num=c, output_num=16, compute_dtype=JB)
        tmod = tm.Siamese(input_num=c, output_num=16, compute_dtype=TB)
        x_j = jnp.asarray(rng.randn(4, 3, c), JB)
        x_t = torch.from_numpy(f32(x_j)).to(TB)
    params, state = randomize_bn(*np_tree(jmod.init(jax.random.PRNGKey(13))), 13)
    return jmod, bridged(tmod, params, state, False), params, state, x_j, x_t


def head_grads(name):
    """Per-parameter bf16 gradients (by port name, fp64) of a fixed random
    functional of the eval-mode outputs: the port's, grl_tpu's."""
    jmod, tmod, params, state, x_j, x_t = head_case(name)
    outs = jax.eval_shape(lambda p: jmod.apply(p, state, x_j)[0], params)
    r = [np.random.RandomState(14 + i).randn(*o.shape).astype(np.float32) for i, o in enumerate(outs)]

    def functional(p):
        return sum(jnp.sum(o.astype(jnp.float32) * ri) for o, ri in zip(jmod.apply(p, state, x_j)[0], r))

    want = state_dict_from_jax(np_tree(jax.jit(jax.grad(functional))(params)), state, tmod)
    sum((o.float() * torch.from_numpy(ri)).sum() for o, ri in zip(tmod(x_t), r)).backward()
    got = {n: p.grad.double() for n, p in tmod.named_parameters() if p.grad is not None}
    return got, {n: want[n].double() for n in got}


@pytest.mark.parametrize("name", ["grl", "siamese"])
def test_bf16_gradients_match_grl_tpu(name):
    """The backward pass through the casts (conv and linear in bf16, the
    sigmoid's gradient, the GCE's fp32 global product, the fp32 Siamese
    products and norms), leaf by leaf against grl_tpu's bf16 gradient: the
    gradient of a fixed random functional of the outputs, in eval mode,
    where BN is a fixed affine map (in train mode the GRL BN-neck
    normalizes the small differences between nearly alike clip features,
    and both packages' bf16 gradients read 0.44-0.70 from each other at
    the median leaf, as far as from fp32). Every leaf is held: a zero or
    wrong gradient reads 1."""
    got, want = head_grads(name)
    dist = {k: float((got[k] - want[k]).norm() / want[k].norm()) for k in want}
    worst = max(dist, key=dist.get)
    median = float(np.median(list(dist.values())))
    limit = GRAD_TOL[name]
    assert median <= limit["median"], f"median leaf {median:.4g}"
    assert dist[worst] <= limit["leaf"], f"{worst}: {dist[worst]:.4g}"


# ---- the CLIs ----

TINY = ["-d", "synthetic", "--tiny", "--seq_len", "2", "-j", "2"]


FOUND_AT_IMPORT = precision_flags()


def run(module, argv, calls):
    """``module.main`` on the parsed ``argv`` (on the CPU) with both TF32
    flags turned on first; records the flags ``main`` left in ``calls``,
    then restores the flags found and ``sys.stdout``."""
    if module is t_extract:
        args = module.build_parser().parse_args(["--device", "cpu", *argv])
    else:
        args = module.build_parser().parse_args([*argv, "--device", "cpu"])
    found, stdout = precision_flags(), sys.stdout
    set_precision_flags(dict.fromkeys(found, True))
    try:
        result = module.main(args)
        calls.append((module.__name__.rsplit(".", 1)[1], argv[0] if module is t_extract else None,
                      precision_flags()))
        return result
    finally:
        set_precision_flags(found)
        sys.stdout = stdout


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """One ``--bf16`` training epoch with the re-ranked evaluation, an fp32
    epoch beside it, then on the bf16 checkpoint ``cli.evaluate --bf16
    --rerank 1``, ``features --bf16`` and ``export-model --bf16`` +
    ``describe``."""
    tmp = tmp_path_factory.mktemp("bf16")
    out = argparse.Namespace(dir=tmp, calls=[], num_classes=SyntheticVideoReID(seed=0).num_train_pids)
    common = [*TINY, "-b", "4", "--epochs", "1"]
    out.top1 = run(t_train, [*common, "--bf16", "--rerank", "1", "--logs-dir", str(tmp / "bf16")], out.calls)
    run(t_train, [*common, "--logs-dir", str(tmp / "fp32")], out.calls)
    out.ckpt = str(tmp / "bf16" / "checkpoint.npz")
    out.top1_eval = run(t_eval, [*TINY, "--bf16", "--rerank", "1", "--seed", "0", "--logs-dir", str(tmp / "eval"),
                                 "--checkpoint", out.ckpt, "--save-distmat", str(tmp / "dist.npz")], out.calls)
    out.features_argv = ["features", *TINY, "--bf16", "--checkpoint", out.ckpt, "--split", "query",
                         "-o", str(tmp / "features.npz")]
    run(t_extract, out.features_argv, out.calls)
    out.meta = run(t_extract, ["export-model", "--checkpoint", out.ckpt, "--tiny", "--bf16", "--num-classes",
                               str(out.num_classes), "--batch", "4", "--seq_len", "2", "--height", "64",
                               "--width", "32", "-o", str(tmp / "model.npz")], out.calls)
    out.clips = np.random.RandomState(0).randint(0, 256, (6, 2, 64, 32, 3), np.uint8)
    np.savez(tmp / "clips.npz", clips=out.clips)
    run(t_extract, ["describe", "--model", str(tmp / "model.npz"), "--clips", str(tmp / "clips.npz"),
                    "-o", str(tmp / "described.npz")], out.calls)
    return out


def bf16_state(num_classes, ckpt):
    """The CLIs' ``--tiny --bf16`` train state on the CPU, from ``ckpt``."""
    cnn, sia, unc = t_train.build_models(argparse.Namespace(arch2="siamese", seed=0, bf16=True), tiny=True)
    state = init_train_state(cnn, sia, unc, num_classes, num_feat=cnn.num_feat, device="cpu")
    load_train_state(state, ckpt)
    return state


@pytest.mark.parametrize("which", ["train", "evaluate", "features", "export-model"])
def test_bf16_flag_runs_through_the_cli(cli, which):
    """Each ``--bf16`` passes its CLI's checks and runs to the end: bf16
    modules, fp32 descriptors, the re-ranked evaluation."""
    if which in ("train", "evaluate"):
        module = t_train if which == "train" else t_eval
        module.validate_args(module.build_parser().parse_args([*TINY, "--bf16"]))
    else:
        argv = cli.features_argv if which == "features" else ["export-model", "--bf16", "-o", "m.npz"]
        t_extract.build_parser().parse_args(["--device", "cpu", *argv])
    state = bf16_state(cli.num_classes, cli.ckpt)
    cnn, sia = state.models["cnn"].eval(), state.models["siamese"].eval()
    assert cnn.backbone.base.conv1.compute_dtype == TB and sia.featQ.compute_dtype == TB
    if which == "train":
        assert 0.0 <= cli.top1 <= 1.0
        log = (cli.dir / "bf16" / "log_train0.txt").read_text()
        assert "Applying person re-ranking" in log and "Namespace(" in log and "bf16=True" in log
        assert int(np.load(cli.ckpt)["extra_epoch"]) == 1
    elif which == "evaluate":
        saved = np.load(cli.dir / "dist.npz")
        assert 0.0 <= cli.top1_eval <= 1.0 and bool(saved["rerank"])
        assert saved["distmat"].dtype == np.float32 and np.isfinite(saved["distmat"]).all()
        assert saved["distmat"].shape == (len(saved["q_pids"]), len(saved["g_pids"]))
    elif which == "features":
        args = t_extract.build_parser().parse_args(["--device", "cpu", *cli.features_argv])
        _, _, _, query, _ = get_data(args.dataset, args.data_dir, 2, args.seq_len, args.seq_srd, args.workers,
                                     only_eval=True, split_id=args.split_id,
                                     dataset_kwargs=t_train._synthetic_kwargs(args))
        want, pids, _ = Evaluator(cnn, sia, micro_batch=args.micro_batch, device="cpu").extract_features(query)
        got = np.load(cli.dir / "features.npz")
        assert got["features"].dtype == np.float32 and want.dtype == torch.float32
        np.testing.assert_array_equal(got["pids"], pids)
        np.testing.assert_array_equal(got["features"], want.numpy())
    else:
        # the artifact keeps fp32 weights with the casts inside, and its
        # output equals the in-process bf16 descriptor
        assert cli.meta["dim"] == 3 * cnn.num_feat
        with np.load(cli.dir / "model.npz") as z:
            program = torch.export.load(io.BytesIO(z["exported"].tobytes()))
        weights = dict(program.named_parameters())
        assert weights and {v.dtype for v in weights.values()} == {torch.float32}
        got = np.load(cli.dir / "described.npz")["features"]
        with torch.no_grad():
            want = torch.cat([make_descriptor_fn(cnn, sia)(torch.from_numpy(cli.clips[i:i + 4]))
                              for i in (0, 4)])[:6]
        assert got.dtype == np.float32 and got.shape == (6, 3 * cnn.num_feat)
        np.testing.assert_array_equal(got, want.numpy())


def test_bf16_checkpoint_is_an_fp32_run_s_tree_and_crosses_to_grl_tpu(cli, tmp_path):
    """A ``--bf16`` run's checkpoint holds the same leaves, shapes and dtypes
    as an fp32 run's; grl_tpu's ``load_train_state`` reads it into its bf16
    models' template, and what grl_tpu writes back loads into the port
    leaf for leaf."""
    bf16, fp32 = np.load(cli.ckpt), np.load(cli.dir / "fp32" / "checkpoint.npz")
    assert sorted(bf16.files) == sorted(fp32.files)
    for k in bf16.files:
        assert bf16[k].dtype == fp32[k].dtype and bf16[k].shape == fp32[k].shape, k
    args = argparse.Namespace(arch2="siamese", bf16=True, use_flow=False, seed=0)
    jcnn, jsia, junc = j_train.build_models(args, tiny=True)
    template = j_init_train_state(jax.random.PRNGKey(0), jcnn, jsia, junc, cli.num_classes,
                                  num_feat=jcnn.num_feat, optimizer=JSGD())
    tree, extras = jser.load_train_state(template, cli.ckpt)
    assert int(extras["epoch"]) == 1
    back = str(tmp_path / "from_grl_tpu.npz")
    jser.save_train_state(tree, {"epoch": 1, "best_top1": 0.0}, back)
    want = serialization.snapshot(bf16_state(cli.num_classes, cli.ckpt)).leaves()
    got = serialization.snapshot(bf16_state(cli.num_classes, back)).leaves()
    assert len(got) == len(want) == len([k for k in bf16.files if k.startswith("leaf_")])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("module", ["train", "evaluate", "extract"])
def test_cli_main_fixes_fp32_with_tf32_off(cli, module):
    """C1: each CLI's ``main`` turns both TF32 flags (and cuBLAS's bf16
    reductions) off, whatever the caller set (the runs above turned them
    on before each call)."""
    calls = [flags for name, _, flags in cli.calls if name == module]
    assert calls, f"no {module} run"
    assert all(flags and not any(flags.values()) for flags in calls), calls
    assert precision_flags() == FOUND_AT_IMPORT  # the runs restored what they found
