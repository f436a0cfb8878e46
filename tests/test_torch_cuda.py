"""The port's hand-written kernels on a CUDA card, against their plain versions.

This file imports torch and grl_tpu_torch only, so it also runs on a
machine without JAX; ``tests/conftest.py`` imports JAX, so skip it there:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips without a card.
"""

import math

import numpy as np
import pytest
import torch

from grl_tpu_torch.engine.evaluator import _euclidean, cosine_distance
from grl_tpu_torch.engine.rerank import re_ranking
from grl_tpu_torch.ops import minplus, minplus_plain, nearest_k, padded_empty
from grl_tpu_torch.ops.minplus import _config, aligned, schedule

pytestmark = pytest.mark.cuda

# fp32 sums of row-normalized values (each ≤ 1) taken in another order
TOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("the hand-written CUDA kernels run only on a card")
    return torch.Generator(device="cuda").manual_seed(0)


def row_normalized(rows, k, gen):
    x = torch.rand(rows, k, device="cuda", generator=gen)
    return x / x.sum(dim=1, keepdim=True)


@pytest.mark.parametrize("shape", [(37, 150, 300), (5, 9, 17), (129, 257, 1000), (128, 256, 64)])
def test_minplus_kernel_matches_plain(gen, shape):
    m, n, k = shape
    a, b = row_normalized(m, k, gen), row_normalized(n, k, gen)
    before = minplus.launches
    out = minplus(a, b)
    torch.cuda.synchronize()
    assert minplus.launches == before + 1
    torch.testing.assert_close(out, minplus_plain(a, b), rtol=0, atol=TOL)


def sparse_rows(rows, k, nnz, gen):
    """V-like rows: ~nnz positive entries out of k, row-normalized."""
    keep = torch.rand(rows, k, device="cuda", generator=gen) < nnz / k
    x = torch.rand(rows, k, device="cuda", generator=gen) * keep
    x[:, 0] += 1e-3  # no empty row
    return x / x.sum(dim=1, keepdim=True)


@pytest.mark.parametrize("shape", [
    (37, 150, 1001),   # k not a multiple of 4
    (40, 70, 5),       # k below one pipeline stage (BK = 32)
    (128, 256, 300),   # m and n at a tile multiple
    (129, 257, 300),   # one above it
    (3, 5, 33),        # one k-chunk and one element over
])
def test_minplus_kernel_edges(gen, shape):
    m, n, k = shape
    a, b = row_normalized(m, k, gen), row_normalized(n, k, gen)
    out = minplus(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, minplus_plain(a, b), rtol=0, atol=TOL)


def test_minplus_kernel_k_zero_gives_zeros(gen):
    a, b = torch.empty(9, 0, device="cuda"), torch.empty(300, 0, device="cuda")
    out = minplus(a, b)
    torch.cuda.synchronize()
    assert out.shape == (9, 300)
    assert bool((out == 0).all())


@pytest.mark.parametrize("k", [64, 1001])
def test_minplus_kernel_more_tiles_than_blocks(gen, k):
    """Whole rounds of persistent blocks, then a tail round (split along k
    at k = 1001)."""
    tile, slots = _config(torch.device("cuda"))
    tiles_n = 8
    tiles_m = -(-(slots + slots // 4) // tiles_n)
    m, n = tiles_m * tile[0] - 5, tiles_n * tile[1] - 3
    grid, dp_tiles, splits = schedule(m, n, k, tile, slots)
    assert grid == slots and dp_tiles == slots and tiles_m * tiles_n > slots
    assert (splits > 1) == (k == 1001)
    a, b = row_normalized(m, k, gen), row_normalized(n, k, gen)
    out = minplus(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, minplus_plain(a, b), rtol=0, atol=TOL)


def test_minplus_kernel_on_sparse_v_like_rows(gen):
    a = sparse_rows(300, 2000, 30, gen)
    b = torch.cat([a, sparse_rows(1700, 2000, 30, gen)])
    out = minplus(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, minplus_plain(a, b), rtol=0, atol=TOL)
    torch.testing.assert_close(out.diagonal(), torch.ones(300, device="cuda"), rtol=0, atol=TOL)


def test_minplus_kernel_split_tiles_are_deterministic(gen):
    """The split tail is summed in a fixed order: two runs agree bit for bit."""
    m, n, k = 129, 257, 1000
    tile, slots = _config(torch.device("cuda"))
    assert schedule(m, n, k, tile, slots)[2] > 1
    a, b = row_normalized(m, k, gen), row_normalized(n, k, gen)
    first = minplus(a, b)
    torch.testing.assert_close(minplus(a, b), first, rtol=0, atol=0)


@pytest.mark.parametrize("padded", [False, True])
def test_minplus_row_strided_views_match_contiguous(gen, padded):
    """Views of wider matrices: misaligned ones are copied into padded rows,
    16-byte aligned ones (``padded_empty``) are read in place."""
    if padded:
        wide_a, wide_b = padded_empty(70, 999, "cuda"), padded_empty(150, 999, "cuda")
        wide_a.copy_(row_normalized(70, 999, gen)), wide_b.copy_(row_normalized(150, 999, gen))
        a, b = wide_a, wide_b[3:]  # row stride 1000
        assert aligned(a) is a and aligned(b) is b
    else:
        wide_a, wide_b = row_normalized(70, 1003, gen), row_normalized(150, 1003, gen)
        a, b = wide_a[:, 1:1000], wide_b[3:, :999]  # row strides 1003, a starts 4 bytes in
        assert aligned(a) is not a and aligned(b) is not b
    assert not a.is_contiguous() and not b.is_contiguous()
    got = minplus(a, b)
    torch.testing.assert_close(got, minplus(a.contiguous(), b.contiguous()), rtol=0, atol=0)
    torch.testing.assert_close(got, minplus_plain(a, b), rtol=0, atol=TOL)


def test_minplus_rejects_what_the_kernel_does_not_take(gen):
    a, b = row_normalized(8, 16, gen), row_normalized(6, 16, gen)
    with pytest.raises(ValueError):
        minplus(a.T.contiguous().T, b)  # column stride 8
    with pytest.raises(ValueError):
        minplus(a, row_normalized(16, 12, gen).T)  # column stride 12
    with pytest.raises(ValueError):
        minplus(a, b.cpu())


def test_rerank_on_card_matches_plain_min_sum(gen):
    feats = torch.randn(120, 64, device="cuda", generator=gen)
    feats = feats / feats.norm(dim=1, keepdim=True)
    qf, gf = feats[:30], feats  # gallery = query ∪ gallery
    dists = cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf)
    before = minplus.launches
    got = re_ranking(*dists)
    torch.cuda.synchronize()
    assert minplus.launches == before + 1
    want = re_ranking(*dists, min_sum_fn=minplus_plain)
    assert got.shape == (30, 120)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_train_step_on_card_matches_cpu(gen, dtype):
    """One tiny-width GRL training step (trunk layers (1, 1, 1, 1), width 4,
    Siamese(128, 16), 2 pairs of 2-frame 64x32 clips) on the card against
    the same step on the CPU. In fp64 the two compute the same function:
    loss terms 1e-9 relative, each parameter's update within 1e-6 of its
    largest element (plus lr x 1e-9: a bias in front of a BN has a zero
    gradient in exact arithmetic), BN statistics and luts 1e-9 absolute. In
    fp32 (well conditioned at this width): loss terms 1e-3 relative, all
    updates together 1e-3 (L2, as a share of the CPU's), BN statistics and
    luts 1e-5 absolute."""
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 convs, as on the CPU
    try:
        _train_step_card_vs_cpu(dtype)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _train_step_card_vs_cpu(dtype):
    from grl_tpu_torch import models
    from grl_tpu_torch.engine import init_train_state, make_train_step

    lr = 1e-3
    g = torch.Generator().manual_seed(0)
    clips = torch.randn(4, 2, 64, 32, 3, generator=g, dtype=dtype)
    luts = {k: torch.randn(3, 128, generator=g, dtype=dtype) for k in ("corr", "uncorr")}
    luts = {k: v / v.norm(dim=1, keepdim=True) for k, v in luts.items()}
    results = {}
    for device in ("cuda", "cpu"):
        cnn = models.GRLModel(trunk=models.ResNetTrunk(layers=(1, 1, 1, 1), width=4))
        sia = models.Siamese(input_num=cnn.num_feat, output_num=16)
        unc = models.SiameseVideo(input_num=cnn.num_feat)
        for i, m in enumerate((cnn, sia, unc)):
            models.init_weights(m, torch.Generator().manual_seed(i))
            m.to(dtype)
        state = init_train_state(cnn, sia, unc, 3, num_feat=cnn.num_feat, device=device)
        state.luts = {k: v.to(device) for k, v in luts.items()}
        before = {k: v.detach().cpu().clone() for k, v in state.models.state_dict().items()}
        state, m = make_train_step(device=device)(state, clips.to(device), [0, 0, 1, 1], lr)
        updates = {k: v.detach().cpu() - before[k] for k, v in state.models.state_dict().items()
                   if not k.endswith("num_batches_tracked")}
        results[device] = ({k: float(v) for k, v in m.items()}, updates,
                           {k: v.cpu() for k, v in state.luts.items()})
    (gm, gu, gl), (cm, cu, cl) = results["cuda"], results["cpu"]
    exact = dtype == torch.float64
    for k in gm:
        if k.startswith("loss"):
            assert abs(gm[k] - cm[k]) <= (1e-9 if exact else 1e-3) * abs(cm[k]), (k, gm[k], cm[k])
    stats = [k for k in cu if k.endswith(("running_mean", "running_var"))]
    params = [k for k in cu if k not in stats]
    if exact:
        for k in params:
            limit = 1e-6 * float(cu[k].abs().max()) + lr * 1e-9
            assert float((gu[k] - cu[k]).abs().max()) <= limit, k
    else:
        flat = lambda u: torch.cat([u[k].flatten() for k in params])
        assert float((flat(gu) - flat(cu)).norm()) <= 1e-3 * float(flat(cu).norm())
    tol = 1e-9 if exact else 1e-5
    for k in stats:
        assert float((gu[k] - cu[k]).abs().max()) <= tol, k
    for k in gl:
        torch.testing.assert_close(gl[k], cl[k], rtol=0, atol=tol)


def _tiny_train_state(device):
    """The CLIs' ``--tiny`` models and train state (5 classes) on ``device``."""
    import argparse

    from grl_tpu_torch.cli.train import build_models
    from grl_tpu_torch.engine import init_train_state

    cnn, sia, unc = build_models(argparse.Namespace(arch2="siamese", seed=0), tiny=True)
    return init_train_state(cnn, sia, unc, 5, num_feat=cnn.num_feat, device=device)


def _card_steps(state, gen, n):
    from grl_tpu_torch.engine import make_train_step

    step = make_train_step(device="cuda")
    for _ in range(n):
        clips = torch.randn(4, 2, 64, 32, 3, device="cuda", generator=gen)
        state, _ = step(state, clips, [0, 0, 3, 3], 1e-3)
    return state


def test_checkpoint_from_the_card_reads_back_bit_equal_on_the_cpu(gen, tmp_path):
    from grl_tpu_torch.utils import load_train_state, save_train_state, serialization

    state = _card_steps(_tiny_train_state("cuda"), gen, 2)
    path = str(tmp_path / "checkpoint.npz")
    save_train_state(state, {"epoch": 1, "best_top1": 0.5}, path)
    cpu = _tiny_train_state("cpu")
    extras = load_train_state(cpu, path)
    assert int(extras["epoch"]) == 1 and cpu.step == state.step == 2
    for key, module in state.models.items():
        for name, value in module.state_dict().items():
            assert torch.equal(cpu.models[key].state_dict()[name], value.cpu()) or name.endswith(
                "num_batches_tracked"), f"{key}.{name}"
    for p_card, p_cpu in zip(state.models.parameters(), cpu.models.parameters()):
        assert torch.equal(cpu.optimizer.state[p_cpu]["momentum_buffer"],
                           state.optimizer.state[p_card]["momentum_buffer"].cpu())
    for k in ("corr", "uncorr"):
        assert torch.equal(cpu.luts[k], state.luts[k].cpu())
    got, want = serialization.snapshot(cpu).leaves(), serialization.snapshot(state).leaves()
    assert all(a.dtype == b.dtype and a.tobytes() == b.tobytes() for a, b in zip(got, want))


def test_async_snapshot_is_isolated_from_the_next_steps_on_the_card(gen, tmp_path, monkeypatch):
    """Steps and an in-place edit queued on the card's stream right after
    ``save`` do not reach the file: the snapshot is ordered before them.
    The writer's pull is held back until they are queued."""
    import threading

    from grl_tpu_torch.utils import AsyncCheckpointer, serialization

    state = _card_steps(_tiny_train_state("cuda"), gen, 1)
    want = serialization.snapshot(state).leaves()
    gate, pull = threading.Event(), serialization.Snapshot._pull
    monkeypatch.setattr(serialization.Snapshot, "_pull", lambda self: gate.wait(60) and pull(self))
    ckpt = AsyncCheckpointer()
    ckpt.save(state, {"epoch": 1}, str(tmp_path / "c.npz"))
    state = _card_steps(state, gen, 3)
    with torch.no_grad():
        for p in state.models.parameters():
            p.add_(1.0)
    gate.set()
    ckpt.wait()
    with np.load(tmp_path / "c.npz") as data:
        for i, leaf in enumerate(want):
            np.testing.assert_array_equal(data[f"leaf_{i:05d}"], leaf)
    assert ckpt.last_write_seconds > 0 and ckpt.last_bytes > 0


def test_rerank_stage_spans_time_the_card_and_add_nothing_to_its_trace(gen):
    """Under a CUDA-only profiler the one-program builder's stages record
    their device milliseconds from CUDA events, answer as without the
    profiler, and leave no event of their own on the device timeline."""
    from torch.profiler import ProfilerActivity, profile

    from grl_tpu_torch.utils import profiling

    feats = torch.randn(120, 64, device="cuda", generator=gen)
    feats = feats / feats.norm(dim=1, keepdim=True)
    dists = cosine_distance(feats[:30], feats), _euclidean(feats[:30], feats[:30]), _euclidean(feats, feats)
    want = re_ranking(*dists)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = re_ranking(*dists)
        torch.cuda.synchronize()
    spans = {sp.name: sp for sp in profiling.spans()}
    profiling.clear()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    stages = {"rerank.original", "rerank.nearest", "rerank.expand", "rerank.query_expand", "rerank.min_sum",
              "rerank.blend"}
    assert set(spans) == stages and all(sp.device_ms > 0 for sp in spans.values())
    device = [ev.name() for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == torch.autograd.DeviceType.CUDA and ev.duration_ns() > 0]
    assert any("minplus" in name for name in device)
    assert not [name for name in device if name in stages or "Event" in name]


NEAREST_LAYOUTS = {
    "uniform": lambda n, gen: torch.rand(256, n, device="cuda", generator=gen),
    # values 0..3: every row ties across every k boundary
    "lattice": lambda n, gen: torch.randint(0, 4, (256, n), device="cuda", generator=gen).float(),
    # re_ranking_padded's pad rows: 0 on the diagonal, 2.0 elsewhere
    "padded_rows": lambda n, gen: torch.full((256, n), 2.0, device="cuda").fill_diagonal_(0.0),
}


@pytest.mark.parametrize("k", [1, 6, 21, 32, 41, 100])
@pytest.mark.parametrize("n", [11598, 16384, 19960, 32768])
@pytest.mark.parametrize("layout", sorted(NEAREST_LAYOUTS))
def test_nearest_kernel_equals_the_stable_argsort_prefix(gen, layout, n, k):
    """At the serve route's n, the one-program cut, the staged phase's n and
    the kernel's widest, in one round of 32 columns and in several, index
    for index."""
    x = NEAREST_LAYOUTS[layout](n, gen)
    before = nearest_k.launches
    got = nearest_k(x, k)
    torch.cuda.synchronize()
    assert nearest_k.launches == before + 1
    assert torch.equal(got, torch.argsort(x, dim=1, stable=True)[:, :k])


NEAREST_EDGES = {
    "n_13_clamps_k": (lambda gen: torch.rand(300, 13, device="cuda", generator=gen), 21),
    "n_700_below_two_columns_a_thread": (lambda gen: torch.rand(300, 700, device="cuda", generator=gen), 32),
    "k_equals_n": (lambda gen: torch.rand(50, 32, device="cuda", generator=gen), 32),
    "all_tied": (lambda gen: torch.zeros(64, 5000, device="cuda"), 21),
    "row_strided_view": (lambda gen: torch.rand(300, 11603, device="cuda", generator=gen)[:, 5:], 21),
    "one_row": (lambda gen: torch.rand(1, 16384, device="cuda", generator=gen), 21),
    "k_equals_n_in_four_rounds": (lambda gen: torch.rand(50, 100, device="cuda", generator=gen), 100),
    "all_tied_past_one_round": (lambda gen: torch.zeros(64, 5000, device="cuda"), 70),
    "crowded_candidates": (lambda gen: crowded_rows(gen), 32),
}


def crowded_rows(gen, rows=16, n=32768, threads=512):
    """Rows whose first 31 of the kernel's 512 threads hold only tiny values
    and the 32nd one middling value below the rest: each of those 31 threads'
    64 columns is a candidate, 31 x 64 + 1 of the 32 x 64 slots."""
    x = 1.0 + torch.rand(rows, n, device="cuda", generator=gen)
    view = x.view(rows, n // threads, threads)
    view[:, :, :31] = 0.5 * torch.rand(rows, n // threads, 31, device="cuda", generator=gen)
    view[:, 0, 31] = 0.75
    return x


@pytest.mark.parametrize("case", sorted(NEAREST_EDGES))
def test_nearest_kernel_at_the_designs_edges(gen, case):
    make, k = NEAREST_EDGES[case]
    x = make(gen)
    got = nearest_k(x, k)
    torch.cuda.synchronize()
    assert got.shape == (x.shape[0], min(k, x.shape[1]))
    assert torch.equal(got, torch.argsort(x, dim=1, stable=True)[:, :k])


def clustered_unit_rows(rows, gen, ids=60, dim=256):
    """Unit rows around ``ids`` centres: each row's nearest are its centre's."""
    centres = torch.randn(ids, dim, device="cuda", generator=gen)
    pick = torch.randint(0, ids, (rows,), device="cuda", generator=gen)
    f = centres / centres.norm(dim=1, keepdim=True)
    f = f[pick] + 0.8 * torch.randn(rows, dim, device="cuda", generator=gen) / dim**0.5
    return f / f.norm(dim=1, keepdim=True)


@pytest.mark.parametrize("k1", [20, 40])
@pytest.mark.parametrize("route", ["one_program", "padded"])
def test_rerank_routes_select_with_the_kernel_to_the_sorts_bits(gen, monkeypatch, route, k1):
    """The one-program and padded builders launch the selection kernel
    once, and give the same V and distances, bit for bit, as with the
    stable argsort's lists, at the default k1 and at one past a round."""
    from grl_tpu_torch.engine import rerank

    feats = clustered_unit_rows(2000, gen)
    qf, gf = feats[:200], feats
    dists = cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf)
    if route == "padded":  # 200 of 232 query rows, 2000 of 2100 gallery rows valid, garbage past them
        pads = [torch.full((232, 2100), 1e6, device="cuda"), torch.full((232, 232), -5.0, device="cuda"),
                torch.full((2100, 2100), 3e-8, device="cuda")]
        for pad, d in zip(pads, dists):
            pad[: d.shape[0], : d.shape[1]] = d
        run = lambda: rerank.re_ranking_padded(*pads, 200, 2000, k1=k1)[:200, :2000]
    else:
        run = lambda: rerank.re_ranking(*dists, k1=k1)
    vs, real = [], rerank.v_from_original
    monkeypatch.setattr(rerank, "v_from_original", lambda *a: vs.append(real(*a)) or vs[-1])

    before = nearest_k.launches
    got = run()
    torch.cuda.synchronize()
    assert nearest_k.launches == before + 1
    monkeypatch.setattr(rerank, "nearest_k", lambda x, k: torch.argsort(x, dim=1, stable=True)[:, :k])
    want = run()
    assert nearest_k.launches == before + 1
    assert torch.equal(vs[0], vs[1]) and torch.equal(got, want)


def test_staged_and_padded_builders_on_card_match_plain_min_sum(gen, monkeypatch):
    """The staged builder (3 min-plus slabs, ragged row blocks) and the
    capacity-padded builder launch the kernel and agree with the plain
    min-sum and with the one-program builder."""
    from grl_tpu_torch.engine import rerank

    monkeypatch.setattr(rerank, "_MINPLUS_CHUNK", 64)
    monkeypatch.setattr(rerank, "_STAGE_BLOCK", 48)
    feats = torch.randn(150, 64, device="cuda", generator=gen)
    feats = feats / feats.norm(dim=1, keepdim=True)
    qf, gf = feats[:30], feats
    dists = cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf)
    before = minplus.launches
    monkeypatch.setattr(rerank, "ONE_PROGRAM_MAX", 179)  # the staged builder at n = 180
    staged = rerank.re_ranking(*dists)
    torch.cuda.synchronize()
    assert minplus.launches == before + 3  # ceil(180 / 64) slabs
    torch.testing.assert_close(staged, rerank.re_ranking(*dists, min_sum_fn=minplus_plain), rtol=0, atol=TOL)
    monkeypatch.setattr(rerank, "ONE_PROGRAM_MAX", 180)  # the one-program builder
    torch.testing.assert_close(staged, rerank.re_ranking(*dists), rtol=0, atol=TOL)

    # the serve daemon's geometry: 30 of 32 query rows, 150 of 200 gallery
    # rows valid, garbage in the padding
    pads = [torch.full((32, 200), 1e6, device="cuda"), torch.full((32, 32), -5.0, device="cuda"),
            torch.full((200, 200), 3e-8, device="cuda")]
    for pad, d in zip(pads, dists):
        pad[: d.shape[0], : d.shape[1]] = d
    before = minplus.launches
    padded = rerank.re_ranking_padded(*pads, 30, 150)
    torch.cuda.synchronize()
    assert minplus.launches == before + 1
    want = rerank.re_ranking_padded(*pads, 30, 150, min_sum_fn=minplus_plain)
    torch.testing.assert_close(padded[:30, :150], want[:30, :150], rtol=0, atol=TOL)
    torch.testing.assert_close(padded[:30, :150], staged, rtol=0, atol=TOL)
    masked = rerank.re_ranking(*pads, valid=(30, 150))
    torch.testing.assert_close(masked[:30, :150], staged, rtol=0, atol=TOL)


def test_padded_expansion_on_card_equals_dense_products_at_the_serve_shape(gen, monkeypatch):
    """At the serve daemon's shape (16 of 32 query rows, zero past them, and
    11310 gallery rows: identity-clustered unit 6144-d features),
    ``re_ranking_padded``'s expansion from the neighbour lists, and its
    final distances, are the dense 0/1 products' bit for bit."""
    from torch_oracle import dense_expansion

    from grl_tpu_torch.engine import rerank

    nq, q_pad, g, dim = 16, 32, 11310, 6144
    centres = torch.randn(636, dim, device="cuda", generator=gen)
    centres = centres / centres.norm(dim=1, keepdim=True)
    ids = torch.randint(0, 636, (q_pad + g,), device="cuda", generator=gen)
    feats = centres[ids] + 0.8 * torch.randn(q_pad + g, dim, device="cuda", generator=gen) / dim**0.5
    feats = feats / feats.norm(dim=1, keepdim=True)
    qf, gf = feats[:q_pad].clone(), feats[q_pad:]
    qf[nq:] = 0.0
    dists = cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf)

    real, calls = rerank._expansion_rows, []

    def recorded(*args, **kw):
        calls.append((args, kw, real(*args, **kw)))
        return calls[-1][2]

    monkeypatch.setattr(rerank, "_expansion_rows", recorded)
    got = rerank.re_ranking_padded(*dists, nq, g)
    ((idx_k1, idx_half), kw, expansion), = calls
    assert kw == {} and idx_k1.shape == (q_pad + g, 21) and idx_half.shape == (q_pad + g, 11)
    assert torch.equal(expansion, dense_expansion(idx_k1, idx_half))
    monkeypatch.setattr(rerank, "_expansion_rows", dense_expansion)
    want = rerank.re_ranking_padded(*dists, nq, g)
    assert torch.equal(got[:nq, :g], want[:nq, :g])


def test_artifact_exported_on_card_serves_in_process(gen, tmp_path):
    """export-model on the card, then the daemon over stdin/stdout in this
    process: the program's descriptors equal the modules', and a re-ranked
    rank launches the min-plus kernel once."""
    import io
    import json

    from grl_tpu_torch.cli import extract
    from grl_tpu_torch.engine import make_descriptor_fn
    from grl_tpu_torch.utils import save_train_state

    state = _tiny_train_state("cuda")
    save_train_state(state, {"epoch": 0}, str(tmp_path / "ckpt.npz"))
    parser = extract.build_parser()
    extract.main(parser.parse_args([
        "--device", "cuda", "export-model", "--checkpoint", str(tmp_path / "ckpt.npz"), "--tiny",
        "--num-classes", "5", "--batch", "4", "--seq_len", "2", "--height", "64", "--width", "32",
        "-o", str(tmp_path / "model.npz")]))
    rng = np.random.RandomState(0)
    clips = rng.randint(0, 256, (6, 2, 64, 32, 3), np.uint8)
    np.savez(tmp_path / "clips.npz", clips=clips)
    feats = rng.randn(44, 384).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=1, keepdims=True)
    np.savez(tmp_path / "gallery.npz", features=feats[:40])
    np.savez(tmp_path / "queries.npz", features=feats[40:])
    reqs = [{"op": "ping"}, {"op": "describe", "clips": str(tmp_path / "clips.npz"), "out": str(tmp_path / "f.npz")},
            {"op": "rank", "features": str(tmp_path / "queries.npz"), "rerank": True, "topk": 5},
            {"op": "shutdown"}]
    out = io.StringIO()
    before = minplus.launches
    extract.serve(parser.parse_args(["--device", "cuda", "serve", "--model", str(tmp_path / "model.npz"),
                                     "--gallery", str(tmp_path / "gallery.npz"), "--rerank-queries", "4"]),
                  inp=io.StringIO("".join(json.dumps(r) + "\n" for r in reqs)), out=out)
    ping, desc, rank, bye = [json.loads(line) for line in out.getvalue().splitlines()]
    assert ping["platform"] == "cuda" and desc["ok"] and rank["reranked"] and bye["ok"]
    assert minplus.launches == before + 1
    with torch.inference_mode():
        want = make_descriptor_fn(state.models["cnn"].eval(), state.models["siamese"].eval())(
            torch.from_numpy(clips).cuda()).cpu().numpy()
    np.testing.assert_allclose(np.load(tmp_path / "f.npz")["features"], want, rtol=0, atol=1e-4)


def test_artifact_call_replays_one_graph_per_batch(gen, tmp_path):
    """``_load_artifact`` on the card replays one CUDA graph per call: on two
    different batches in a row its answers equal the eager program's, the
    first answer is not overwritten by the second call, and ``replays``
    counts the calls; a chunk of another shape is refused."""
    import io

    from grl_tpu_torch.cli import extract
    from grl_tpu_torch.utils import save_train_state

    save_train_state(_tiny_train_state("cuda"), {"epoch": 0}, str(tmp_path / "ckpt.npz"))
    extract.main(extract.build_parser().parse_args([
        "--device", "cuda", "export-model", "--checkpoint", str(tmp_path / "ckpt.npz"), "--tiny",
        "--num-classes", "5", "--batch", "4", "--seq_len", "2", "--height", "64", "--width", "32",
        "-o", str(tmp_path / "model.npz")]))
    call, meta = extract._load_artifact(str(tmp_path / "model.npz"), "cuda")
    assert isinstance(call, extract._GraphCall) and call.replays == 0 and call.pool_bytes > 0
    with np.load(tmp_path / "model.npz") as z:
        eager = torch.export.load(io.BytesIO(z["exported"].tobytes())).module()
    rng = np.random.RandomState(0)
    batches = [rng.randint(0, 256, (4, 2, 64, 32, 3), np.uint8) for _ in range(2)]
    first = call(batches[0])
    kept = first.copy()
    second = call(batches[1])
    assert call.replays == 2 and first.dtype == np.float32 and first.shape == (4, meta["dim"])
    np.testing.assert_array_equal(first, kept)
    assert not np.array_equal(first, second)
    with torch.inference_mode():
        for got, clips in zip((first, second), batches):
            want = eager(torch.from_numpy(clips).cuda()).float().cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="graph takes"):
        call(batches[0][:2])
    assert call.replays == 2


def _bf16_models(bf16=True):
    """The CLIs' ``--tiny`` modules (``--bf16`` or fp32) with seed-0 weights, on the CPU."""
    import argparse

    from grl_tpu_torch.cli.train import build_models

    return build_models(argparse.Namespace(arch2="siamese", seed=0, bf16=bf16), tiny=True)


def test_bf16_descriptor_on_card_matches_bf16_on_cpu(gen):
    """The tiny-width bf16 descriptor on the card against the same modules
    in bf16 on the CPU: fp32 out on both; each 128-d segment's per-row
    cosine ≥ 0.999 and every element within 16 bf16 ulps (2⁻⁸ each) of the
    CPU descriptor's largest (cuDNN and oneDNN sum bf16 products in
    another order, and a flipped rounding carries through the layers)."""
    import copy

    from grl_tpu_torch.engine import make_descriptor_fn

    cnn, sia, _ = _bf16_models()
    clips = torch.randint(0, 256, (4, 2, 64, 32, 3), dtype=torch.uint8, device="cuda", generator=gen)
    with torch.inference_mode():
        cpu = make_descriptor_fn(cnn.eval(), sia.eval())(clips.cpu())
        card = make_descriptor_fn(copy.deepcopy(cnn).cuda(), copy.deepcopy(sia).cuda())(clips).cpu()
    assert cpu.dtype == card.dtype == torch.float32
    for i in range(3):
        seg = slice(128 * i, 128 * (i + 1))
        assert float(torch.nn.functional.cosine_similarity(card[:, seg], cpu[:, seg], dim=1).min()) >= 0.999
    assert float((card - cpu).abs().max()) <= 16 * 2.0 ** -8 * float(cpu.abs().max())


def _bf16_step(device, bf16, clips, luts, lr=1e-3):
    """One tiny step of fresh seed-0 modules on ``device``: (metrics,
    parameter updates, BN statistics, luts), on the CPU in fp64."""
    from grl_tpu_torch.engine import init_train_state, make_train_step

    cnn, sia, unc = _bf16_models(bf16)
    state = init_train_state(cnn, sia, unc, 3, num_feat=cnn.num_feat, device=device)
    state.luts = {k: v.to(device) for k, v in luts.items()}
    before = {k: v.detach().double().cpu().clone() for k, v in state.models.state_dict().items()}
    state, m = make_train_step(device=device)(state, clips.to(device), [0, 0, 1, 1], lr)
    for p in state.models.parameters():
        assert p.dtype == torch.float32
    for lut in state.luts.values():
        assert lut.dtype == torch.float32
        torch.testing.assert_close(lut.norm(dim=1), torch.ones(3, device=device), rtol=0, atol=1e-5)
    after = {k: v.detach().double().cpu() for k, v in state.models.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    stats = {k: v for k, v in after.items() if k.endswith(("running_mean", "running_var"))}
    updates = {k: v - before[k] for k, v in after.items() if k not in stats}
    return ({k: float(v) for k, v in m.items()}, updates, stats,
            {k: v.double().cpu() for k, v in state.luts.items()})


# leaves whose bf16 update is rounding: a bias in front of a train-mode BN
# through a linear map (zero in exact arithmetic), the mask's 1-channel BN
# bias (one sum over every pixel), the 2-way classifier's bias (two values
# summing to zero)
ROUNDING_LEAVES = ("cnn.backbone.glo_fc.0.bias", "cnn.backbone.corr_atte.1.bias", "cnn.backbone.corr_atte.6.bias",
                   "siamese.featQ.bias", "siamese.featK.bias", "siamese.classifierlinear.bias")
# card against CPU, one bf16 step from the same state, each limit beside
# its reading on NVIDIA H100 80GB HBM3: loss terms relative (2.5e-7); per
# parameter leaf (but ROUNDING_LEAVES) the update's cosine and norm ratio,
# at the median leaf (0.99998, 1.0004) and at every leaf (lowest cosine
# 0.9978, ratios 0.990-1.021); BN statistics in shares of each one's
# largest element (4.2e-5); luts max abs (3.0e-8). Both round per op alike,
# so the step agrees far closer than with grl_tpu's. A zero update reads
# cosine 0 and ratio 0.
BF16_STEP_TOL = {"loss": 1e-4, "cosine": 0.999, "ratio": (0.99, 1.01), "leaf_cosine": 0.98, "leaf_ratio": (0.9, 1.1),
                 "bn": 1e-3, "lut": 1e-5}


def _bf16_step_readings():
    """One tiny bf16 step on the card and on the CPU from the same state:
    the card's readings against the CPU's."""
    g = torch.Generator().manual_seed(0)
    clips = torch.randn(4, 2, 64, 32, 3, generator=g)
    luts = {k: torch.randn(3, 128, generator=g) for k in ("corr", "uncorr")}
    luts = {k: v / v.norm(dim=1, keepdim=True) for k, v in luts.items()}
    (cm, cu, cst, cl), (m, u, st, lu) = _bf16_step("cuda", True, clips, luts), _bf16_step("cpu", True, clips, luts)
    leaves = {}
    for k in u:
        if k not in ROUNDING_LEAVES and float(u[k].norm()) > 0:
            a, b = cu[k].flatten(), u[k].flatten()
            leaves[k] = (float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300)), float(a.norm() / b.norm()))
    return {"finite": all(math.isfinite(v) for v in cm.values()),
            "loss": max(abs(cm[k] - m[k]) / abs(m[k]) for k in m if k.startswith("loss")),
            "cosine": float(np.median([v[0] for v in leaves.values()])),
            "ratio": float(np.median([v[1] for v in leaves.values()])),
            "lowest_cosine": min(leaves.items(), key=lambda kv: kv[1][0]),
            "ratios": (min(v[1] for v in leaves.values()), max(v[1] for v in leaves.values())),
            "bn": max(float((cst[k] - st[k]).abs().max() / st[k].abs().max()) for k in st),
            "lut": max(float((cl[k] - lu[k]).abs().max()) for k in lu)}


def test_bf16_train_step_on_card_matches_cpu(gen):
    """One tiny-width bf16 training step on the card against the same step
    on the CPU, leaf by leaf (``BF16_STEP_TOL``); fp32 parameters and
    luts, finite metrics."""
    r, tol = _bf16_step_readings(), BF16_STEP_TOL
    assert r["finite"], r
    assert r["loss"] <= tol["loss"] and r["bn"] <= tol["bn"] and r["lut"] <= tol["lut"], r
    assert r["cosine"] >= tol["cosine"] and tol["ratio"][0] <= r["ratio"] <= tol["ratio"][1], r
    assert r["lowest_cosine"][1][0] >= tol["leaf_cosine"], r
    assert tol["leaf_ratio"][0] <= r["ratios"][0] and r["ratios"][1] <= tol["leaf_ratio"][1], r


@pytest.fixture
def fp32_policy():
    """The CLIs' precision policy (TF32 off) for the test, restored after."""
    from grl_tpu_torch import precision_flags, set_precision, set_precision_flags

    before = precision_flags()
    set_precision()
    yield
    set_precision_flags(before)


def _card_vs_cpu(model, clips_cpu):
    """``model`` (eval mode) on the CPU and a copy on the card: outputs as
    a tuple of CPU tensors each."""
    import copy

    with torch.inference_mode():
        cpu = model.eval()(clips_cpu)
        card = copy.deepcopy(model).cuda()(clips_cpu.cuda())
    as_tuple = lambda out: out if isinstance(out, tuple) else (out,)
    return as_tuple(cpu), tuple(t.cpu() for t in as_tuple(card))


def test_flow_grl_model_on_card_matches_cpu(gen, fp32_policy):
    """The ``--use-flow`` GRL model (6-channel tiny trunk) on 6-channel clips."""
    from grl_tpu_torch import models
    from grl_tpu_torch.data import normalize

    trunk = models.ResNetTrunk(layers=(1, 1, 1, 1), width=4, in_channels=6)
    cnn = models.create("resnet50_grl", device="cpu", seed=0, trunk=trunk)
    clips = normalize(torch.randint(0, 256, (2, 4, 64, 32, 6), dtype=torch.uint8, generator=torch.Generator()
                                    .manual_seed(0)))
    cpu, card = _card_vs_cpu(cnn, clips)
    for a, b in zip(cpu, card):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["resnet50", "two_stream"])
def test_per_frame_baselines_on_card_match_cpu(gen, fp32_policy, name):
    """``ResNetBaseline`` and ``TwoStreamBaseline`` at full width, both heads."""
    from grl_tpu_torch import models

    model = models.create(name, device="cpu", seed=0, num_features=128)
    channels = 6 if name == "two_stream" else 3
    clips = torch.randn(2, 2, 64, 32, channels, generator=torch.Generator().manual_seed(1))
    cpu, card = _card_vs_cpu(model, clips)
    for a, b in zip(cpu, card):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-3)


def test_dense_evaluator_stages_through_reused_pinned_slots_with_no_pageable_upload(gen, fp32_policy):
    """Seven micro-batches of 16 distinct full-width clips through the dense
    path twice: the staging slots are pinned and the same buffers both
    times; the features match a synchronous reference (each micro-batch of
    the concatenated clips uploaded, described and summed, then waited for)
    within fp32 atomic-add noise, so no slot is refilled before its upload
    ran; under a profiler no pageable host-to-device copy runs between the
    first and the last describe, the pinned ones do, and the host waits for
    a slot at most once a micro-batch."""
    from torch.profiler import ProfilerActivity, profile

    from grl_tpu_torch import models as tm
    from grl_tpu_torch.data import ClipDataset, ClipLoader
    from grl_tpu_torch.engine import Evaluator
    from grl_tpu_torch.utils import profiling

    mb, seq_len, frame = 16, 8, (256, 128)
    rng = np.random.RandomState(0)
    clip_counts = (5, 17, 9, 30, 3, 11, 20, 12)  # 107 clips: six micro-batches and a short seventh
    items = [(rng.randint(0, 256, (n * seq_len, *frame, 3), np.uint8), i, 0) for i, n in enumerate(clip_counts)]

    def loader():
        return ClipLoader(ClipDataset(items, seq_len, "dense", *frame), batch_size=1, workers=2)

    torch.manual_seed(0)
    cnn = tm.GRLModel(trunk=tm.ResNetTrunk())
    ev = Evaluator(cnn, tm.Siamese(input_num=cnn.num_feat, output_num=512), micro_batch=mb, device="cuda")
    got, _, _ = ev.extract_features(loader())
    slots = ev._slots[1]
    ptrs = [s.clips.data_ptr() for s in slots]
    assert all(s.clips.is_pinned() and s.ids.is_pinned() for s in slots)

    clips = np.concatenate([c for c, _, _ in loader()])
    ids = np.repeat(np.arange(len(clip_counts)), clip_counts)
    want = torch.zeros_like(got)
    with torch.inference_mode():
        for i in range(0, len(ids), mb):
            d = ev._describe(torch.from_numpy(clips[i : i + mb]).cuda())
            want.index_add_(0, torch.from_numpy(ids[i : i + mb]).cuda(), d)
            torch.cuda.synchronize()
        want /= torch.tensor(clip_counts, dtype=torch.float32, device="cuda")[:, None]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))

    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        again, _, _ = ev.extract_features(loader())
        torch.cuda.synchronize()
    spans = profiling.spans()
    profiling.clear()
    assert [s.clips.data_ptr() for s in ev._slots[1]] == ptrs
    torch.testing.assert_close(again, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    describes = [sp for sp in spans if sp.name == "evaluator.describe"]
    assert len(describes) == 7
    assert sum(sp.name == "evaluator.stage_wait" for sp in spans) <= len(describes)
    lo, hi = min(sp.start_ns for sp in describes), max(sp.end_ns for sp in describes)
    copies = [ev_.name() for ev_ in prof.profiler.kineto_results.events()
              if "Memcpy HtoD" in ev_.name() and lo <= ev_.start_ns() <= hi]
    assert copies and not [name for name in copies if "Pageable" in name], copies
