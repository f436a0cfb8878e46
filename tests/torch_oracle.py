"""Functional PyTorch oracle for numeric parity tests.

Evaluates the reference GRL math (reid/models/{resnets1,basebranch,
grl_model,Siamese}.py) directly with torch.nn.functional, driven by
grl_tpu's own parameter pytrees — so a single random init feeds both the
JAX implementation and this oracle, and outputs can be compared bit-for-
semantics (including BatchNorm train-mode running-stat trajectories).

All oracle tensors are NCHW; tests convert at the boundary.
"""

import numpy as np
import torch
import torch.nn.functional as F


def T(a):
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.asarray(a).copy())


def mutable_bn_states(state):
    """Deep-convert a state pytree's mean/var leaves into torch tensors that
    F.batch_norm can update in place."""
    if isinstance(state, dict):
        if set(state.keys()) == {"mean", "var"}:
            return {"mean": T(state["mean"]), "var": T(state["var"])}
        return {k: mutable_bn_states(v) for k, v in state.items()}
    return state


def conv(p, x, stride=1, padding=0):
    w = T(p["kernel"]).permute(3, 2, 0, 1)
    b = T(p["bias"]) if "bias" in p else None
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def bn(p, s, x, training):
    return F.batch_norm(x, s["mean"], s["var"], T(p["scale"]), T(p["bias"]),
                        training, 0.1, 1e-5)


def linear(p, x):
    return F.linear(x, T(p["kernel"]).t(), T(p["bias"]) if "bias" in p else None)


def unit(x, dim=1):
    return x / x.norm(2, dim, keepdim=True)


def bottleneck(mod, p, s, x, training):
    out = F.relu(bn(p["bn1"], s["bn1"], conv(p["conv1"], x), training))
    out = F.relu(bn(p["bn2"], s["bn2"], conv(p["conv2"], out, stride=mod.stride, padding=1), training))
    out = bn(p["bn3"], s["bn3"], conv(p["conv3"], out), training)
    if mod.has_downsample:
        dp, ds = p["downsample"], s["downsample"]
        x = bn(dp["1"], ds["1"], conv(dp["0"], x, stride=mod.stride), training)
    return F.relu(out + x)


def trunk(mod, p, s, x, training):
    x = F.relu(bn(p["bn1"], s["bn1"], conv(p["conv1"], x, stride=2, padding=3), training))
    x = F.max_pool2d(x, 3, 2, 1)
    for li in range(1, 5):
        layer = mod.children[f"layer{li}"]
        for bi, block in enumerate(layer.modules):
            x = bottleneck(block, p[f"layer{li}"][str(bi)], s[f"layer{li}"][str(bi)], x, training)
    return x


def gce(mod, p, s, clips, training):
    """clips: (b, t, 3, h, w) -> (x_uncorr, x_corr, mask), each (b*t, C, h', w')."""
    b, t = clips.shape[0], clips.shape[1]
    frames = clips.reshape(b * t, *clips.shape[2:])
    x = trunk(mod.children["base"], p["base"], s["base"], frames, training)
    c, fh, fw = x.shape[1], x.shape[2], x.shape[3]

    x_glo = x.reshape(b, t, c, fh, fw).mean(dim=(-1, -2)).mean(dim=1)
    g = p["glo_fc"], s["glo_fc"]
    glo = F.relu(bn(g[0]["1"], g[1]["1"], linear(g[0]["0"], x_glo), training))
    glo_map = glo[:, None, :, None, None].expand(b, t, glo.shape[1], fh, fw)
    glo_map = glo_map.reshape(b * t, glo.shape[1], fh, fw)

    a = p["corr_atte"], s["corr_atte"]
    h = torch.cat([x, glo_map], dim=1)
    h = bn(a[0]["1"], a[1]["1"], conv(a[0]["0"], h), training)
    h = F.relu(bn(a[0]["3"], a[1]["3"], conv(a[0]["2"], h), training))
    h = bn(a[0]["6"], a[1]["6"], conv(a[0]["5"], h), training)
    mask = torch.sigmoid(h)
    return x * (1 - mask), x * mask, mask


def memory_block(p, s, x, training):
    out = F.relu(bn(p["bn1"], s["bn1"], conv(p["conv1"], x), training))
    out = F.relu(bn(p["bn2"], s["bn2"], conv(p["conv2"], out), training))
    out = bn(p["bn3"], s["bn3"], conv(p["conv3"], out), training)
    return F.relu(out + x)


def trl(p, s, x_uncorr, x_corr, training):
    """Inputs (b, t, C, h, w); returns (f_uncorr (b, C), f_corr (b, t, C))."""
    b, t, c, h, w = x_corr.shape
    memo = {"fwd": x_uncorr.mean(dim=1), "bwd": x_uncorr.mean(dim=1)}
    steps = {"fwd": [], "bwd": []}
    for i in range(t):
        for d, idx in (("fwd", i), ("bwd", t - 1 - i)):
            dp, dst = p[d], s[d]
            xc, xu = x_corr[:, idx], x_uncorr[:, idx]
            f1 = F.relu(conv(dp["f1"], memo[d]))
            f2 = F.relu(conv(dp["f2"], xc))
            diff = (f1 - f2).pow(2).mean(dim=(-1, -2))
            att = torch.sigmoid(linear(dp["atte"]["2"], F.relu(linear(dp["atte"]["0"], diff))))
            enhanced = xc * att[:, :, None, None] + xc
            steps[d].append(enhanced.mean(dim=(-1, -2)))
            memo[d] = memory_block(dp["memo"], dst["memo"], memo[d] + xu, training)
    f_corr = torch.stack(steps["fwd"], dim=1) + torch.stack(steps["bwd"][::-1], dim=1)
    f_uncorr = memo["fwd"].mean(dim=(-1, -2)) + memo["bwd"].mean(dim=(-1, -2))
    return f_uncorr, f_corr


def grl_model(mod, p, s, clips, training):
    """clips (b, t, 3, h, w) -> (x_uncorr (b, C), x_corr (b, t, C))."""
    b, t = clips.shape[0], clips.shape[1]
    x_uncorr, x_corr, _ = gce(mod.children["backbone"], p["backbone"], s["backbone"], clips, training)
    c, fh, fw = x_corr.shape[1:]
    f_uncorr, f_corr = trl(
        p["temporal_learning_block"], s["temporal_learning_block"],
        x_uncorr.reshape(b, t, c, fh, fw), x_corr.reshape(b, t, c, fh, fw), training,
    )
    f_corr = bn(p["corr_bn"], s["corr_bn"], f_corr.reshape(b * t, c), training)
    f_corr = F.normalize(f_corr.reshape(b, t, c), p=2, dim=2)
    f_uncorr = bn(p["uncorr_bn"], s["uncorr_bn"], f_uncorr, training)
    f_uncorr = F.normalize(f_uncorr, p=2, dim=1)
    return f_uncorr, f_corr


def siamese_attention(p, s, x, training):
    """x (b, t, C) -> pooled (b, C)."""
    b, t, c = x.shape
    q = unit(bn(p["featQ_bn"], s["featQ_bn"], linear(p["featQ"], x.reshape(b * t, c)), training)).reshape(b, t, -1)
    k = unit(bn(p["featK_bn"], s["featK_bn"], linear(p["featK"], x.reshape(b * t, c)), training)).reshape(b, t, -1)
    w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
    return unit((w @ x).sum(dim=1))


def siamese_video(p, s, x, training):
    """x (b, C) interleaved pairs -> (scores (b/2, b/2, 2), out (b, C))."""
    half = x.shape[0] // 2
    pairs = x.reshape(half, 2, -1)
    pp, pg = pairs[:, 0], pairs[:, 1]
    out = torch.cat([pp, pg])
    diff = (pp[:, None] - pg[None, :]).pow(2).reshape(half * half, -1)
    scores = linear(p["classifierlinear"], bn(p["classifierBN"], s["classifierBN"], diff, training))
    return scores.reshape(half, half, 2), out


def siamese(p, s, x, training):
    """x (b, t, C) interleaved pairs -> (scores (b/2, b/2, 2), pooled (b, C))."""
    half = x.shape[0] // 2
    pairs = x.reshape(half, 2, x.shape[1], x.shape[2])
    pp = siamese_attention(p, s, pairs[:, 0], training)
    pg = siamese_attention(p, s, pairs[:, 1], training)
    out = torch.cat([pp, pg])
    diff = (pp[:, None] - pg[None, :]).pow(2).reshape(half * half, -1)
    scores = linear(p["classifierlinear"], bn(p["classifierBN"], s["classifierBN"], diff, training))
    return scores.reshape(half, half, 2), out


def dense_expansion(idx_k1, idx_half):
    """Re-ranking's k-reciprocal expansion in its dense form, the
    definition's own: the (n, n) bool adjacencies of every row's nearest
    indices ``idx_k1`` and ``idx_half``, ``A ∧ Aᵀ`` of each, and the two
    0/1 products ``|R(i) ∩ B(c)|`` and ``∪ B(c)`` over the qualifying ``c``
    in bf16 (integers ≤ k1+1, exact). The oracle of
    ``engine.rerank._expansion_rows``."""
    n = idx_k1.shape[0]

    def mutual(idx):
        adj = torch.zeros((n, n), dtype=torch.bool, device=idx.device)
        adj.scatter_(1, idx.long(), True)
        return adj & adj.T

    reciprocal, b = mutual(idx_k1), mutual(idx_half)
    b_sizes = b.sum(dim=1).to(torch.float32)
    bf = b.to(torch.bfloat16)
    overlap = (reciprocal.to(torch.bfloat16) @ bf.T).to(torch.float32)
    qualifies = reciprocal & (overlap > (2.0 / 3.0) * b_sizes[None, :])
    return reciprocal | ((qualifies.to(torch.bfloat16) @ bf) > 0)
