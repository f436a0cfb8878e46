"""The port's losses against grl_tpu's: values and gradients.

Same seeded numpy inputs through the JAX loss (its gradient by
``jax.grad``) and the port's (by autograd); atol 1e-5 on values and
gradients unless a case says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grl_tpu import losses as jl
from grl_tpu_torch import losses as tl

ATOL = 1e-5


def unit_rows(rng, n, c):
    x = rng.randn(n, c).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def torch_value_and_grad(fn, *arrays):
    """fn(*tensors) -> scalar; returns (value, grad wrt the first array)."""
    x = torch.tensor(arrays[0], requires_grad=True)
    rest = [torch.as_tensor(a) for a in arrays[1:]]
    out = fn(x, *rest)
    out.backward()
    return out.detach().numpy(), x.grad.numpy()


def jax_value_and_grad(fn, *arrays):
    value, grad = jax.value_and_grad(fn)(*[jnp.asarray(a) for a in arrays])
    return np.asarray(value), np.asarray(grad)


def close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def test_oim_logits_and_cross_entropy():
    rng = np.random.RandomState(0)
    x, lut = unit_rows(rng, 6, 32), unit_rows(rng, 5, 32)
    y = np.array([0, 3, 3, 1, 4, 0], np.int64)
    want = jax_value_and_grad(lambda a, l, t: jl.cross_entropy(jl.oim_logits(a, l, 30.0), t), x, lut, y)
    got = torch_value_and_grad(lambda a, l, t: tl.cross_entropy(tl.oim_logits(a, l, 30.0), t), x, lut, y)
    close(got[0], want[0])
    close(got[1], want[1])


def test_oim_lut_takes_no_gradient():
    rng = np.random.RandomState(1)
    x = torch.tensor(unit_rows(rng, 4, 16), requires_grad=True)
    lut = torch.tensor(unit_rows(rng, 3, 16), requires_grad=True)
    tl.cross_entropy(tl.oim_logits(x, lut), torch.tensor([0, 1, 2, 1])).backward()
    assert lut.grad is None and x.grad is not None


def sequential_update(lut, feats, targets, momentum=0.5):
    """The reference's loop: one row at a time, in batch order."""
    lut = lut.copy()
    for x, y in zip(feats, targets):
        row = momentum * lut[y] + (1 - momentum) * x
        lut[y] = row / np.linalg.norm(row)
    return lut


@pytest.mark.parametrize("targets", [
    [2] * 16,                                 # one id, sixteen times (2t under the pair sampler)
    [0, 0, 1, 1, 0, 0, 3, 3, 1, 1, 0, 0],     # interleaved repeats
    [4, 1, 3, 0],                             # no repeat: one round
], ids=["one_id_x16", "interleaved", "distinct"])
def test_update_lut_matches_grl_tpu_and_sequential_loop(targets):
    rng = np.random.RandomState(len(targets))
    lut = unit_rows(rng, 5, 24)
    lut[4] = 0.0  # a zero row, as at init
    feats = unit_rows(rng, len(targets), 24)
    y = np.array(targets, np.int64)
    want = np.asarray(jl.update_lut(jnp.asarray(lut), jnp.asarray(feats), jnp.asarray(y), 0.5))
    loop = sequential_update(lut, feats, y)
    got = tl.update_lut(torch.from_numpy(lut), torch.from_numpy(feats), torch.from_numpy(y), 0.5)
    given = tl.update_lut(torch.from_numpy(lut), torch.from_numpy(feats), torch.from_numpy(y), 0.5,
                          rounds=tl.max_repeats(y))
    close(got.numpy(), want, atol=1e-6)
    close(got.numpy(), loop, atol=1e-6)
    np.testing.assert_array_equal(given.numpy(), got.numpy())
    assert tl.max_repeats(y) == max(targets.count(v) for v in set(targets))


def test_oim_loss_bundle_matches_grl_tpu():
    rng = np.random.RandomState(2)
    lut, x = unit_rows(rng, 4, 8), unit_rows(rng, 6, 8)
    y = np.array([0, 1, 1, 3, 3, 3])
    jloss, jlogits, jlut = jl.OIMLoss(8, 4)(jnp.asarray(lut), jnp.asarray(x), jnp.asarray(y))
    oim = tl.OIMLoss(8, 4)
    assert oim.init(device="cpu").shape == (4, 8)
    loss, logits, new_lut = oim(torch.from_numpy(lut), torch.from_numpy(x), torch.from_numpy(y))
    close(loss.numpy(), np.asarray(jloss))
    close(logits.numpy(), np.asarray(jlogits), atol=1e-4)
    close(new_lut.numpy(), np.asarray(jlut), atol=1e-6)


def pair_inputs(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    scores = (scale * rng.randn(3, 3, 2)).astype(np.float32)
    return scores, np.array([0, 1, 2]), np.array([0, 2, 2])


@pytest.mark.parametrize("scale", [1.0, 5.0])
def test_pair_loss_from_logits_matches_grl_tpu(scale):
    scores, tp, tg = pair_inputs(3, scale)
    want = jax_value_and_grad(lambda s, a, b: jl.pair_loss_from_logits(s, a, b)[0], scores, tp, tg)
    got = torch_value_and_grad(lambda s, a, b: tl.pair_loss_from_logits(s, a, b)[0], scores, tp, tg)
    close(got[0], want[0])
    close(got[1], want[1])
    _, jacc = jl.pair_loss_from_logits(jnp.asarray(scores), jnp.asarray(tp), jnp.asarray(tg))
    _, acc = tl.pair_loss_from_logits(torch.from_numpy(scores), torch.from_numpy(tp), torch.from_numpy(tg))
    close(acc.numpy(), np.asarray(jacc))


def test_pair_loss_probability_form_matches_grl_tpu():
    scores, tp, tg = pair_inputs(4)
    probs = (1.0 / (1.0 + np.exp(scores[..., 0] - scores[..., 1]))).astype(np.float32)
    probs[0, 0] = 0.0  # log clamps at -100, as BCELoss does
    want = jax_value_and_grad(lambda p, a, b: jl.pair_loss(p, a, b)[0], probs, tp, tg)
    got = torch_value_and_grad(lambda p, a, b: tl.pair_loss(p, a, b)[0], probs, tp, tg)
    close(got[0], want[0], atol=1e-4)
    np.testing.assert_allclose(tl.PairLoss()(torch.from_numpy(probs), torch.from_numpy(tp),
                                              torch.from_numpy(tg))[1].numpy(),
                               np.asarray(jl.PairLoss()(probs, tp, tg)[1]))
    mask = probs != 0.0  # d/dp at p = 0 is inf in both
    close(got[1][mask], want[1][mask], atol=1e-4, rtol=1e-5)


def test_pair_loss_from_logits_gradient_finite_when_saturated():
    scores = np.zeros((2, 2, 2), np.float32)
    scores[..., 0], scores[..., 1] = -200.0, 200.0  # class-1 probability rounds to exactly 1
    tp, tg = np.array([0, 1]), np.array([0, 2])    # one positive, three negatives
    want = jax_value_and_grad(lambda s, a, b: jl.pair_loss_from_logits(s, a, b)[0], scores, tp, tg)
    got = torch_value_and_grad(lambda s, a, b: tl.pair_loss_from_logits(s, a, b)[0], scores, tp, tg)
    assert np.isfinite(got[0]) and np.isfinite(got[1]).all()
    close(got[0], want[0], atol=1e-3, rtol=1e-6)  # ~300, fp32
    close(got[1], want[1])


def test_euclidean_cdist_matches_grl_tpu():
    rng = np.random.RandomState(5)
    a, b = rng.randn(5, 16).astype(np.float32), rng.randn(7, 16).astype(np.float32)
    got = tl.euclidean_cdist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    close(got, np.asarray(jl.euclidean_cdist(a, b)), atol=1e-5)
    want = jax_value_and_grad(lambda x, y: jl.euclidean_cdist(x, y).sum(), a, b)
    grad = torch_value_and_grad(lambda x, y: tl.euclidean_cdist(x, y).sum(), a, b)
    close(grad[1], want[1], atol=1e-4)


def triplet_inputs(seed, ties=False):
    """Small-integer features: every Gram entry is exact in fp32, so equal
    distances tie exactly in both packages whatever their GEMM's order."""
    rng = np.random.RandomState(seed)
    feats = rng.randint(-2, 3, (8, 16)).astype(np.float32)
    ids = np.array([0, 0, 1, 1, 2, 2, 0, 1])
    if ties:
        # anchor 0's two positives sit at one distance (rows 1 and 6 equal),
        # and two negatives of anchor 2 are one point (rows 4 and 5)
        feats[6] = feats[1]
        feats[5] = feats[4]
    return feats, ids


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_triplet_matches_grl_tpu(ties):
    feats, ids = triplet_inputs(6, ties)
    jloss, tloss = jl.TripletLoss("soft", True), tl.TripletLoss("soft", True)
    want = jax_value_and_grad(lambda f, y: jnp.mean(jloss(f, y)), feats, ids)
    got = torch_value_and_grad(lambda f, y: tloss(f, y).mean(), feats, ids)
    close(got[0], want[0])
    close(got[1], want[1])
    per_anchor = tloss(torch.from_numpy(feats), torch.from_numpy(ids)).numpy()
    close(per_anchor, np.asarray(jloss(feats, ids)))


def test_triplet_hard_margin_and_oim_variant_match_grl_tpu():
    feats, ids = triplet_inputs(7, ties=True)
    lut = np.random.RandomState(8).randint(-2, 3, (3, 16)).astype(np.float32)
    for margin in ("soft", 0.3):
        want = jax_value_and_grad(
            lambda f, l, y: jnp.mean(jl.TripletLossOIM(margin)(f, l, y)), feats, lut, ids)
        got = torch_value_and_grad(
            lambda f, l, y: tl.TripletLossOIM(margin)(f, l, y).mean(), feats, lut, ids)
        close(got[0], want[0])
        close(got[1], want[1])
    want = jax_value_and_grad(lambda f, y: jnp.mean(jl.TripletLoss(0.3)(f, y)), feats, ids)
    got = torch_value_and_grad(lambda f, y: tl.TripletLoss(0.3)(f, y).mean(), feats, ids)
    close(got[0], want[0])
    close(got[1], want[1])
    with pytest.raises(NotImplementedError):
        tl.TripletLoss("hard")
