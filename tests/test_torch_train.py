"""The port's training path against grl_tpu's, on the CPU.

Tiny widths as tests/test_train_step.py: trunk ``layers=(1, 1, 1, 1)``,
``width=4`` (128 channels out), ``Siamese(output_num=16)``, B=4 clips of
T=2 frames. Weights, BN statistics (seeded, not the identity init) and
luts (non-zero unit rows) come from grl_tpu's init through the bridges;
clips and ids from numpy seeds. Tolerances: losses rtol 2e-4, parameters
rtol 5e-3 / atol 1e-4 (those of test_train_step.py), luts rtol 1e-4 /
atol 1e-5, BN running statistics rtol 1e-3 / atol 1e-5. A step's update
of each leaf (new - old) must also agree within 1e-2 of that leaf's
largest update, plus 1e-7 absolute: at the reference lr (1e-3) an update
is far below the parameter tolerance's atol, so this is what holds the
optimizer's arithmetic. Frames are 64x32: at 32x16 the TRL memory block's
train-mode BN normalizes over 8 values per channel, and a second step
turns the first step's fp32 rounding into percents of an update.

One comparison takes a wider tolerance: the luts after the second of two
chained steps, atol 5e-5. They move by the second step's features, which
each package computes from its own first-step parameters; those agree to
about 1e-3 of an update (train-mode BN over the 4 rows of a Siamese
half-batch amplifies fp32 rounding), and the features inherit it, just
above atol 1e-5. From grl_tpu's own first-step state (the bridged test)
the luts hold rtol 1e-4 / atol 1e-5, and after the first step too.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu import models as jm
from grl_tpu.data import loader as jloader
from grl_tpu.data import sampling as jsampling
from grl_tpu.data import transforms as jtransforms
from grl_tpu.data.catalogs.synthetic import SyntheticVideoReID as JSynthetic
from grl_tpu.engine.optim import SGD as JSGD
from grl_tpu.engine.optim import lr_mult_tree as j_lr_mult_tree
from grl_tpu.engine.train_step import init_train_state as j_init_train_state
from grl_tpu.engine.train_step import make_train_step as j_make_train_step
from grl_tpu_torch import models as tm
from grl_tpu_torch.data import ClipDataset, ClipLoader, RandomPairSampler, SyntheticVideoReID
from grl_tpu_torch.data import transforms
from grl_tpu_torch.engine import (Trainer, init_train_state, lr_mult_tree, make_train_step,
                                  step_decay_lr)
from grl_tpu_torch.utils import state_dict_from_jax, train_state_from_jax
from test_torch_models import randomize_bn

B, T, H, W = 4, 2, 64, 32
WIDTH = 4
NUM_CLASSES = 3
LR = (1e-3, 2e-3)
PARAM_TOL = dict(rtol=5e-3, atol=1e-4)
UPDATE_RTOL, UPDATE_ATOL = 1e-2, 1e-7
STAT_TOL = dict(rtol=1e-3, atol=1e-5)
LUT_TOL = dict(rtol=1e-4, atol=1e-5)
CHAINED_LUT_TOL = dict(rtol=1e-4, atol=5e-5)
LOSS_RTOL = 2e-4


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_models():
    cnn = jm.GRLModel(trunk=jm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))
    return cnn, jm.Siamese(input_num=cnn.num_feat, output_num=16), jm.SiameseVideo(input_num=cnn.num_feat)


def port_models():
    cnn = tm.GRLModel(trunk=tm.ResNetTrunk(layers=(1, 1, 1, 1), last_stride=1, width=WIDTH))
    return cnn, tm.Siamese(input_num=cnn.num_feat, output_num=16), tm.SiameseVideo(input_num=cnn.num_feat)


def bridged(module, params, state):
    module.load_state_dict(state_dict_from_jax(params, state, module), strict=True)
    return module


def assert_module_matches(module, params, state, what):
    """Every parameter and BN running statistic of ``module`` against
    grl_tpu's trees."""
    want = state_dict_from_jax(np_tree(params), np_tree(state), module)
    for key, got in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = STAT_TOL if key.endswith(("running_mean", "running_var")) else PARAM_TOL
        np.testing.assert_allclose(got.detach().numpy(), want[key].numpy(), **tol,
                                   err_msg=f"{what}: {key}")


# ---- train-mode modules ----

def test_siamese_forward_train_mode_matches_grl_tpu():
    js, ts = jm.Siamese(input_num=64, output_num=16), tm.Siamese(input_num=64, output_num=16)
    params, state = randomize_bn(*np_tree(js.init(jax.random.PRNGKey(1))), 1)
    x = np.random.RandomState(1).randn(6, 3, 64).astype(np.float32)
    (want_scores, want_out), new_state = js.apply(params, state, jnp.asarray(x), training=True)
    bridged(ts, params, state).train()
    scores, out = ts(torch.from_numpy(x))
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_scores), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
    assert_module_matches(ts, params, new_state, "Siamese")
    # featV_bn is never applied: its statistics stay where they were
    np.testing.assert_array_equal(ts.featV_bn.running_mean.numpy(), state["featV_bn"]["mean"])


def test_siamese_video_train_mode_matches_grl_tpu():
    js, ts = jm.SiameseVideo(input_num=32), tm.create("siamese_video", device="cpu", input_num=32)
    params, state = randomize_bn(*np_tree(js.init(jax.random.PRNGKey(2))), 2)
    x = np.random.RandomState(2).randn(6, 32).astype(np.float32)
    (want_scores, want_out), new_state = js.apply(params, state, jnp.asarray(x), training=True)
    bridged(ts, params, state).train()
    scores, out = ts(torch.from_numpy(x))
    assert tuple(scores.shape) == (3, 3, 2)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(want_scores), rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want_out))
    assert_module_matches(ts, params, new_state, "SiameseVideo")


def test_grl_model_train_mode_matches_grl_tpu():
    """Outputs and every BN's new running statistics (TRL's memory blocks
    advance t times per direction) at 64x32 frames, where train-mode BN over
    layer4's maps has enough elements per channel to stay out of fp32 noise."""
    jcnn, _, _ = jax_models()
    tcnn, _, _ = port_models()
    params, state = randomize_bn(*np_tree(jcnn.init(jax.random.PRNGKey(3))), 3)
    x = np.random.RandomState(3).randn(B, T, 64, 32, 3).astype(np.float32)
    (want_u, want_c), new_state = jcnn.apply(params, state, jnp.asarray(x), training=True)
    bridged(tcnn, params, state).train()
    got_u, got_c = tcnn(torch.from_numpy(x))
    np.testing.assert_allclose(got_u.detach().numpy(), np.asarray(want_u), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got_c.detach().numpy(), np.asarray(want_c), rtol=2e-4, atol=2e-4)
    assert_module_matches(tcnn, params, new_state, "GRLModel")


# ---- the train step ----

def batches():
    rng = np.random.RandomState(11)
    clips = [rng.randn(B, T, H, W, 3).astype(np.float32) for _ in LR]
    return list(zip(clips, [np.array([0, 0, 1, 1]), np.array([2, 2, 0, 0])], LR))


def run_jax_steps():
    """grl_tpu's init (seeded BN, non-zero luts) and its states after one
    and two steps, with each step's metrics."""
    cnn, siamese, unc = jax_models()
    ts = j_init_train_state(jax.random.PRNGKey(0), cnn, siamese, unc, NUM_CLASSES, num_feat=cnn.num_feat)
    ts = np_tree(ts)
    for i, key in enumerate(("cnn", "siamese", "siamese_uncorr")):
        randomize_bn(ts["params"][key], ts["model_state"][key], 20 + i)
    rng = np.random.RandomState(1)
    for k in ("corr", "uncorr"):
        lut = rng.randn(NUM_CLASSES, cnn.num_feat).astype(np.float32)
        ts["luts"][k] = lut / np.linalg.norm(lut, axis=1, keepdims=True)
    step = j_make_train_step(cnn, siamese, unc, JSGD(), donate=False)
    states, metrics = [ts], []
    for clips, targets, lr in batches():
        new, m = step(jax.tree.map(jnp.asarray, states[-1]), jnp.asarray(clips),
                      jnp.asarray(targets, jnp.int32), lr)
        states.append(np_tree(new))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


@pytest.fixture(scope="module")
def jax_run():
    return run_jax_steps()


def port_state(tree):
    state = init_train_state(*port_models(), NUM_CLASSES, num_feat=8 * WIDTH * 4, device="cpu")
    return train_state_from_jax(tree, state)


def snapshot(state):
    return {k: {n: v.clone() for n, v in m.state_dict().items()} for k, m in state.models.items()}


def assert_state_matches(state, tree, what, before=None, lut_tol=LUT_TOL):
    """``state`` against grl_tpu's ``tree``; with ``before = (port snapshot,
    grl_tpu tree)`` from before the step, each leaf's update too."""
    for key, module in state.models.items():
        assert_module_matches(module, tree["params"][key], tree["model_state"][key], f"{what} {key}")
        if before is None:
            continue
        want = state_dict_from_jax(tree["params"][key], tree["model_state"][key], module)
        want0 = state_dict_from_jax(before[1]["params"][key], before[1]["model_state"][key], module)
        for name, value in module.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            update, want_update = value - before[0][key][name], want[name] - want0[name]
            limit = UPDATE_RTOL * float(want_update.abs().max()) + UPDATE_ATOL
            err = float((update - want_update).abs().max())
            assert err <= limit, f"{what}: update of {key}.{name} off by {err} (limit {limit})"
    for k in ("corr", "uncorr"):
        np.testing.assert_allclose(state.luts[k].numpy(), tree["luts"][k], **lut_tol, err_msg=f"{what} lut {k}")
    assert state.step == int(tree["step"])


def assert_metrics_match(got, want):
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dim() == 0
        if k.startswith("loss"):
            np.testing.assert_allclose(float(v), want[k], rtol=LOSS_RTOL, err_msg=k)


def test_two_train_steps_match_grl_tpu(jax_run):
    states, metrics = jax_run
    state = port_state(states[0])
    step = make_train_step(device="cpu")
    for i, (clips, targets, lr) in enumerate(batches()):
        before = snapshot(state)
        state, m = step(state, torch.from_numpy(clips), targets, lr)
        assert_metrics_match(m, metrics[i])
        assert_state_matches(state, states[i + 1], f"after step {i + 1}", (before, states[i]),
                             lut_tol=CHAINED_LUT_TOL if i else LUT_TOL)
    # the unreached leaves moved, by weight decay and momentum alone, as in
    # grl_tpu (the update check above holds them to grl_tpu's updates)
    featv = state.models["siamese"].featV.weight.detach().numpy()
    assert not np.array_equal(featv, states[0]["params"]["siamese"]["featV"]["kernel"].T)


def test_step_from_a_later_jax_state_carries_the_momentum(jax_run):
    """Bridge grl_tpu's state after one step (momentum trace, luts, step
    counter) and take the second step in the port."""
    states, metrics = jax_run
    state = port_state(states[1])
    p = state.models["cnn"].backbone.base.conv1.weight
    trace = states[1]["opt"][1].trace["cnn"]["backbone"]["base"]["conv1"]["kernel"]
    np.testing.assert_array_equal(state.optimizer.state[p]["momentum_buffer"].numpy(),
                                  np.transpose(trace, (3, 2, 0, 1)))
    clips, targets, lr = batches()[1]
    before = snapshot(state)
    state, m = make_train_step(device="cpu")(state, torch.from_numpy(clips), targets, lr)
    assert_metrics_match(m, metrics[1])
    assert_state_matches(state, states[2], "second step from the bridged state", (before, states[1]))


def test_lr_multipliers_and_schedule_match_grl_tpu(jax_run):
    states, _ = jax_run
    jmults = j_lr_mult_tree(states[0]["params"], {"cnn/backbone": 1.0}, default=2.0)
    models = torch.nn.ModuleDict(dict(zip(("cnn", "siamese", "siamese_uncorr"), port_models())))
    mults = lr_mult_tree(models.named_parameters(), {"cnn.backbone": 1.0}, default=2.0)
    for name, m in mults.items():
        node = jmults
        for part in name.split(".")[:-1]:
            node = node[part]
        assert set(node.values()) == {m}, name
    assert mults["cnn.backbone.glo_fc.0.weight"] == 1.0 and mults["cnn.corr_bn.weight"] == 2.0
    state = init_train_state(*port_models(), NUM_CLASSES, num_feat=128, device="cpu")
    state.optimizer.set_lr(0.01)
    assert sorted(g["lr"] for g in state.optimizer.param_groups) == [0.01, 0.02]
    for epoch in (0, 14, 15, 29, 30, 44):
        assert step_decay_lr(0.001, epoch) == pytest.approx(0.001 * 0.1 ** (epoch // 15), rel=1e-12)
    assert step_decay_lr(0.01, 10, step_size=5, gamma=0.5) == pytest.approx(0.0025)


# ---- augmentation ----

def u8_clips(seed, b=4, t=3, h=64, w=32):
    return np.random.RandomState(seed).randint(0, 256, (b, t, h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_erase_with_grl_tpu_draws_equals_random_erase(seed):
    """Feed ``erase`` the draws grl_tpu's random_erase makes from its own
    key splits: the result must equal grl_tpu's exactly."""
    clips = u8_clips(seed)
    key = jax.random.PRNGKey(seed)
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


def test_flip_with_grl_tpu_draws_equals_random_flip():
    clips = u8_clips(3)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jtransforms.random_flip(key, jnp.asarray(clips)))
    decision = np.asarray(jax.random.bernoulli(key, 0.5, (clips.shape[0],)))
    assert decision.any() and not decision.all()
    got = transforms.flip(torch.from_numpy(clips), torch.from_numpy(decision))
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_augment_is_seeded_and_clip_consistent():
    clips = torch.from_numpy(u8_clips(4, b=8))
    flipped = transforms.random_flip(torch.Generator().manual_seed(0), clips)
    for i in range(8):  # each clip whole or mirrored, every frame alike
        assert torch.equal(flipped[i], clips[i]) or torch.equal(flipped[i], clips[i].flip(2))
    a = transforms.augment(torch.Generator().manual_seed(5), clips)
    b = transforms.augment(torch.Generator().manual_seed(5), clips)
    assert a.dtype == torch.float32 and a.shape == clips.shape and torch.equal(a, b)
    plain = transforms.augment(torch.Generator().manual_seed(5), clips, train=False)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jtransforms.normalize(clips.numpy())), atol=1e-6)
    erased = transforms.random_erase(torch.Generator().manual_seed(6), clips)
    changed = (erased != clips).flatten(2).any(dim=2).float().mean()
    assert 0.2 < float(changed) < 0.8  # about half the frames (p = 0.5)


# ---- data ----

CATALOG = dict(num_train_ids=6, num_test_ids=2, tracklets_per_id=2, num_cams=2,
               frames_range=(2, 9), height=H, width=W, seed=0)


@pytest.mark.parametrize("options", [
    dict(drop_last=True),
    dict(drop_last=False),
    dict(drop_last=True, max_batches=3),
], ids=["drop_last", "keep_last", "max_batches"])
def test_pair_loader_batches_as_grl_tpu(options):
    jtrain, train = JSynthetic(**CATALOG).train, SyntheticVideoReID(**CATALOG).train
    want = jloader.ClipLoader(jloader.ClipDataset(jtrain, T, "rrs_train", H, W, seed=2), batch_size=6,
                              sampler=jsampling.RandomPairSampler(jtrain, seed=3), workers=2, **options)
    got = ClipLoader(ClipDataset(train, T, "rrs_train", H, W, seed=2), batch_size=6,
                     sampler=RandomPairSampler(train, seed=3), workers=2, **options)
    assert len(got) == len(want)
    for _ in range(2):  # two epochs: sampler and frame draws move on alike
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == len(want)
        for g, w in pairs:
            for a, b in zip(g, w, strict=True):
                np.testing.assert_array_equal(a, b)
            assert (g[1][0::2] == g[1][1::2]).all()  # anchor/positive pairs share an id


def test_shuffled_loader_batches_as_grl_tpu():
    jtrain, train = JSynthetic(**CATALOG).train, SyntheticVideoReID(**CATALOG).train
    want = jloader.ClipLoader(jloader.ClipDataset(jtrain, T, "rrs_test", H, W), batch_size=5,
                              shuffle=True, seed=4, prefetch=1, workers=2)
    got = ClipLoader(ClipDataset(train, T, "rrs_test", H, W), batch_size=5, shuffle=True, seed=4,
                     prefetch=1, workers=2)
    for g, w in zip(got, want, strict=True):
        for a, b in zip(g, w, strict=True):
            np.testing.assert_array_equal(a, b)


# ---- the trainer ----

def test_trainer_runs_a_two_step_epoch_on_the_cpu(capsys):
    ds = SyntheticVideoReID(**CATALOG)
    loader = ClipLoader(ClipDataset(ds.train, T, "rrs_train", H, W), batch_size=B,
                        sampler=RandomPairSampler(ds.train, seed=0), drop_last=True, workers=2,
                        max_batches=2)
    state = init_train_state(*port_models(), ds.num_train_pids, num_feat=128, device="cpu")
    before = state.models["cnn"].backbone.base.conv1.weight.detach().clone()
    trainer = Trainer(make_train_step(device="cpu"), print_freq=1, seed=0, device="cpu")
    state, stats = trainer.train(0, state, loader, step_decay_lr(1e-3, 0))
    assert state.step == 2
    assert set(stats) == {"loss", "prec_uncorr", "prec_vid", "prec_frame", "batch_time", "data_time"}
    assert all(np.isfinite(v) for v in stats.values())
    assert not torch.equal(before, state.models["cnn"].backbone.base.conv1.weight)
    assert capsys.readouterr().out.count("Epoch: [0]") == 2
    for k in ("corr", "uncorr"):  # rows of the ids seen have unit norm
        norms = state.luts[k].norm(dim=1)
        seen = norms > 0
        assert seen.any()
        torch.testing.assert_close(norms[seen], torch.ones(int(seen.sum())), rtol=0, atol=1e-5)

    stop = threading.Event()
    stop.set()
    trainer.stop_event = stop
    state, stats = trainer.train(1, state, loader, 1e-3)
    assert state.step == 2 and stats["loss"] == 0.0


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert Trainer(make_train_step()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(make_train_step(device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(*port_models(), NUM_CLASSES, num_feat=128)
