"""The port's data parallelism (``grl_tpu_torch.parallel``) on the CPU, over
gloo, against one process and against grl_tpu.

Every multi-rank test launches 2 ranks through ``parallel.launch`` (a
``FileStore`` rendezvous under ``tmp_path``, so parallel test workers never
race for a port) running a job of ``tests/test_torch_parallel_worker.py``, with
a timeout past which the ranks are killed and the test fails. Models are
``tests/test_sharding.py``'s tiny widths (trunk ``layers=(1, 1, 1, 1)``,
``width=4``, ``Siamese(output_num=16)``), frames 64x32, 2 frames a clip.

Tolerances, each beside its comparison:
- the group step on 2 ranks against the port's one process on the global
  batch: fp64 rtol 1e-9 / atol 1e-12 on every leaf, two steps (only the
  order of the reductions differs); fp32 the parameter tolerance of
  ``tests/test_sharding.py`` after one step (rtol 2e-3, atol 1e-5) and
  ``tests/test_torch_train.py``'s after the second (rtol 5e-3, atol 1e-4:
  the first step's rounding, amplified, reached 1.7e-5 on a conv1 weight),
  BN statistics rtol 1e-3 / atol 1e-5, luts rtol 1e-4 / atol 1e-5,
  losses rtol 1e-5 after one step and 2e-4 after the second (read: 2.1e-5);
- against grl_tpu's 2-device mesh step (8-device virtual CPU mesh), two
  steps: ``tests/test_torch_train.py``'s bounds for the port against
  grl_tpu on one device (parameters rtol 5e-3 / atol 1e-4, each update
  within 1e-2 of its leaf's largest, BN statistics rtol 1e-3 / atol 1e-5,
  luts rtol 1e-4 / atol 1e-5, atol 5e-5 after the chained step, losses
  rtol 2e-4);
- the multi-process regime against its one-process replays: the same
  bounds, port and grl_tpu;
- the global BatchNorm against one BatchNorm over the joined batch: fp32
  rtol 1e-5 / atol 1e-6 (values and gradients), statistics rtol 1e-6;
- the striped evaluation against one process: distances atol 1e-5 (the
  kernel's check on the card), rank-1 and mAP exactly.
"""

import os
import os.path as osp
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.dirname(__file__))

import test_torch_parallel_worker as W  # noqa: E402
from grl_tpu.engine.optim import SGD as JSGD  # noqa: E402
from grl_tpu.engine.train_step import make_train_step as j_make_train_step  # noqa: E402
from grl_tpu.parallel import auto_mesh as j_auto_mesh  # noqa: E402
from grl_tpu.parallel import data_mesh as j_data_mesh  # noqa: E402
from grl_tpu.parallel import multihost as jmh  # noqa: E402
from grl_tpu.parallel import replicate as j_replicate  # noqa: E402
from grl_tpu.parallel import shard_batch as j_shard_batch  # noqa: E402
from grl_tpu_torch import parallel  # noqa: E402
from grl_tpu_torch.data import get_data  # noqa: E402
from grl_tpu_torch.data.transforms import augment  # noqa: E402
from grl_tpu_torch.engine import Evaluator, Trainer, make_train_step  # noqa: E402
from grl_tpu_torch.parallel import multihost as tmh  # noqa: E402
from test_torch_models import randomize_bn  # noqa: E402
from test_torch_train import (CHAINED_LUT_TOL, LUT_TOL, LOSS_RTOL, PARAM_TOL, assert_state_matches, batches,  # noqa: E402
                              jax_models, np_tree, port_state, run_jax_steps, snapshot)

TIMEOUT = 120  # seconds a 2-rank job may take before its ranks are killed
GROUP_PARAM_TOL = dict(rtol=2e-3, atol=1e-5)  # tests/test_sharding.py's
GROUP_STAT_TOL = dict(rtol=1e-3, atol=1e-5)
FP64_TOL = dict(rtol=1e-9, atol=1e-12)


def run(job, payload, tmp_path, multihost=False):
    return parallel.launch(job, payload, 2, "cpu", workdir=tmp_path, timeout=TIMEOUT, multihost=multihost)


# ---- the catalog functions and the mesh rule ----

def catalog(seed=0, pids=11):
    rng = np.random.RandomState(seed)
    return [(f"frames_{pid}_{i}", pid, int(rng.randint(0, 3))) for pid in range(pids)
            for i in range(rng.randint(1, 7))]


@pytest.mark.parametrize("processes", [1, 2, 3, 4])
def test_catalog_functions_equal_grl_tpu(processes):
    """``shard_catalog``, ``_assign_pids``, ``min_shard_size``,
    ``stripe_catalog`` (one device per process) and ``eval_catalog_meta``
    give grl_tpu's answers at every process index."""
    items = catalog(processes)
    assert tmh._assign_pids(items, processes) == jmh._assign_pids(items, processes)
    assert tmh.min_shard_size(items, processes) == jmh.min_shard_size(items, processes)
    shards = []
    for i in range(processes):
        ours = tmh.shard_catalog(items, i, processes)
        assert ours == jmh.shard_catalog(items, i, processes)
        shards.append(ours)
        for n in (len(items), 5, 1):
            assert tmh.stripe_catalog(items[:n], i, processes) == jmh.stripe_catalog(items[:n], i, processes, 1)
    assert sorted(t for s in shards for t in s) == sorted(items)
    for ours, theirs in zip(tmh.eval_catalog_meta(items), jmh.eval_catalog_meta(items)):
        np.testing.assert_array_equal(ours, theirs)
    with pytest.raises(ValueError, match="empty"):
        tmh.stripe_catalog([], 0, processes)


@pytest.mark.parametrize("pairs,limit", [(None, None), (8, None), (6, None), (3, None), (7, None), (8, 3),
                                         (8, 2), (None, 5), (4, 16), (8, 1)])
def test_auto_mesh_takes_grl_tpu_s_divisor_and_cap(monkeypatch, pairs, limit):
    """With 8 cards visible, the rank count is the size of grl_tpu's
    ``auto_mesh`` on its 8-device virtual mesh (1 where grl_tpu has none);
    on the CPU the count is ``--devices``, still divided into the pairs."""
    monkeypatch.setattr(parallel.mesh.torch.cuda, "device_count", lambda: 8)
    mesh = j_auto_mesh(pairs=pairs, limit=limit)
    assert parallel.auto_mesh(pairs=pairs, limit=limit) == (1 if mesh is None else mesh.devices.size)
    assert parallel.auto_mesh(pairs=pairs, limit=limit, device="cpu") == (
        1 if j_auto_mesh(pairs=pairs, limit=limit or 1) is None else j_auto_mesh(pairs=pairs, limit=limit or 1).devices.size)


def test_shard_batch_slices_and_refuses_what_does_not_divide():
    mesh = parallel.Mesh(1, 4, "cpu")
    x = np.arange(8 * 3).reshape(8, 3)
    np.testing.assert_array_equal(parallel.shard_batch(x, mesh), x[2:4])
    np.testing.assert_array_equal(parallel.shard_batch(x, mesh), np.asarray(j_shard_batch(x, j_data_mesh(4)))[2:4])
    with pytest.raises(ValueError, match="not divisible"):
        parallel.shard_batch(np.zeros((6, 2)), mesh)
    with pytest.raises(ValueError):
        j_shard_batch(np.zeros((6, 2)), j_data_mesh(4))


def test_multihost_refusals_name_what_to_change():
    """A torchrun launch: a batch whose pairs do not split over the ranks,
    and a ``--devices`` that leaves ranks out, exit with grl_tpu's reasons."""
    from grl_tpu_torch.cli import train as t_train

    mesh = parallel.Mesh(0, 4, "cpu", multihost=True)
    args = t_train.build_parser().parse_args(["-b", "12"])
    with pytest.raises(SystemExit, match="multiple of 2 \\* process_count"):
        t_train.check_multihost(args, mesh, 6)
    args = t_train.build_parser().parse_args(["-b", "16", "--devices", "2"])
    with pytest.raises(SystemExit, match="caps the mesh below the global device count"):
        t_train.check_multihost(args, mesh, 8)
    t_train.check_multihost(t_train.build_parser().parse_args(["-b", "16"]), mesh, 8)


# ---- the group's helpers and its failures ----

def test_collectives_of_the_mesh(tmp_path):
    """Host gather and any, the store barrier (twice under one name),
    ``replicate`` from rank 0, and ``gather_striped_rows`` with a row count
    that does not divide."""
    gf = np.random.RandomState(5).randn(15, 12).astype(np.float32)
    out = run(W.job_collectives, dict(gf=gf), tmp_path)
    for r in out:
        np.testing.assert_array_equal(r["gather"], [0, 10, 1, 11])
        assert r["any"] == [True, False]
        np.testing.assert_array_equal(r["replicated"], np.zeros((2, 3)))
        np.testing.assert_array_equal(r["striped"], gf)


def test_a_failing_rank_fails_the_launch(tmp_path):
    """A rank that raises makes ``launch`` raise, its peer (waiting in a
    collective) killed; a group that cannot form on the asked device (CUDA
    on a machine without) raises too: neither falls back to one process."""
    with pytest.raises(RuntimeError, match="rank1 of 2 exited with code 1"):
        run(W.job_fail, None, tmp_path)
    with pytest.raises(RuntimeError, match="exited with code 1"):
        parallel.launch(W.job_fail, None, 2, "cuda", workdir=tmp_path, timeout=TIMEOUT)


# ---- global-batch BatchNorm ----

@pytest.mark.parametrize("shape,dtype", [((8, 3, 5, 4), "float32"), ((8, 6), "float32"),
                                         ((8, 3, 5, 4), "bfloat16")], ids=["2d", "1d", "2d-bf16"])
def test_global_batchnorm_equals_one_batchnorm_over_the_joined_batch(tmp_path, shape, dtype):
    """2 ranks, each with 4 rows drawn from its own distribution (rank
    statistics differ from the global ones): output, input gradient,
    parameter gradients (summed over the ranks) and running statistics
    equal a ``torch.nn.BatchNorm`` on all 8 rows. In bf16 the output is
    bf16 and the statistics stay fp32, held against an fp32 BatchNorm of
    the bf16 input (within a bf16 ulp of its output)."""
    rng = np.random.RandomState(0)
    x = np.concatenate([rng.randn(4, *shape[1:]) * (r + 1) + 3.0 * r for r in range(2)]).astype(np.float32)
    w = rng.randn(*shape).astype(np.float32)
    c = shape[1]
    ref = (torch.nn.BatchNorm2d if len(shape) == 4 else torch.nn.BatchNorm1d)(c)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        ref.bias.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
        ref.running_mean.copy_(torch.from_numpy(rng.randn(c).astype(np.float32)))
        ref.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    bn = {k: v.clone().numpy() for k, v in ref.state_dict().items()}
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).float().requires_grad_(True)
    y = ref(xt)
    (y * torch.from_numpy(w)).sum().backward()
    out = run(W.job_batchnorm, dict(x=x, w=w, bn=bn, dtype=dtype), tmp_path)
    assert not np.allclose(x[:4].mean(0), x.mean(0), atol=0.1)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(np.concatenate([r["y"] for r in out]), y.detach().numpy(), **tol)
    assert {r["y_dtype"] for r in out} == {f"torch.{dtype}"}
    np.testing.assert_allclose(np.concatenate([r["x_grad"] for r in out]), xt.grad.numpy(), **tol)
    grad_tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else tol
    np.testing.assert_allclose(sum(r["w_grad"] for r in out), ref.weight.grad.numpy(), **grad_tol)
    np.testing.assert_allclose(sum(r["b_grad"] for r in out), ref.bias.grad.numpy(), **grad_tol)
    for r in out:
        for k, v in ref.state_dict().items():
            assert r["stats"][k].dtype == v.numpy().dtype, k
            np.testing.assert_allclose(r["stats"][k], v.numpy(), rtol=1e-6, atol=1e-7, err_msg=k)


# ---- the group step ----

@pytest.fixture(scope="module")
def jax_run():
    return run_jax_steps()


@pytest.fixture(scope="module")
def group_run(jax_run, tmp_path_factory):
    """Two group steps on 2 ranks (one pair each) from grl_tpu's init, in
    fp32 and fp64, with test_torch_train.py's batches."""
    states, _ = jax_run
    payload = W.state_payload(port_state(states[0]))
    out = {}
    for dtype in ("float32", "float64"):
        out[dtype] = run(W.job_group_steps, dict(dtype=dtype, state=payload, batches=batches()),
                         tmp_path_factory.mktemp(dtype))
    return out


def one_process_steps(states, dtype):
    # built as the ranks build theirs: from the same numpy payload, so the
    # momentum buffers are made in ``dtype`` by the first step
    state = W.state_from_payload(W.state_payload(port_state(states[0])), dtype)
    step = make_train_step(device="cpu")
    out = []
    for clips, targets, lr in batches():
        state, m = step(state, torch.from_numpy(clips).to(dtype), targets, lr)
        out.append((W.state_payload(state), {k: float(v) for k, v in m.items()}))
    return out


def assert_payloads_close(got, want, tol, stat_tol, lut_tol, what):
    for key, module in want["models"].items():
        for name, value in module.items():
            t = stat_tol if name.endswith(("running_mean", "running_var")) else tol
            np.testing.assert_allclose(got["models"][key][name], value, **t, err_msg=f"{what} {key}.{name}")
    for k, v in want["luts"].items():
        np.testing.assert_allclose(got["luts"][k], v, **lut_tol, err_msg=f"{what} lut {k}")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_group_step_equals_one_process_step_on_the_global_batch(jax_run, group_run, dtype):
    """Both ranks end each of two steps with the same state and metrics,
    and that state is the port's one-process step on the global batch."""
    want = one_process_steps(jax_run[0], getattr(torch, dtype))
    ranks = group_run[dtype]
    for i, (state, m) in enumerate(want):
        r0, r1 = ranks[0][i], ranks[1][i]
        assert r0[1] == r1[1], f"step {i + 1}: the ranks' metrics differ"
        assert_payloads_close(r1[0], r0[0], dict(rtol=0, atol=0), dict(rtol=0, atol=0), dict(rtol=0, atol=0),
                              f"step {i + 1}, rank 1 vs rank 0")
        if dtype == "float64":
            assert_payloads_close(r0[0], state, FP64_TOL, FP64_TOL, FP64_TOL, f"step {i + 1} fp64")
            tol = 1e-12
        else:
            assert_payloads_close(r0[0], state, GROUP_PARAM_TOL if i == 0 else PARAM_TOL, GROUP_STAT_TOL,
                                  LUT_TOL, f"step {i + 1} fp32")
            tol = 1e-5 if i == 0 else LOSS_RTOL
        for k, v in m.items():
            if k.startswith("loss"):
                np.testing.assert_allclose(r0[1][k], v, rtol=tol, err_msg=f"step {i + 1} {k}")


def jax_init(num_classes):
    """grl_tpu's init as ``test_torch_train.run_jax_steps`` makes it (seeded
    BN, unit luts), for ``num_classes`` ids."""
    from grl_tpu.engine.train_step import init_train_state as j_init_train_state

    cnn, siamese, unc = jax_models()
    ts = np_tree(j_init_train_state(jax.random.PRNGKey(0), cnn, siamese, unc, num_classes, num_feat=cnn.num_feat))
    for i, key in enumerate(("cnn", "siamese", "siamese_uncorr")):
        randomize_bn(ts["params"][key], ts["model_state"][key], 20 + i)
    rng = np.random.RandomState(1)
    for k in ("corr", "uncorr"):
        lut = rng.randn(num_classes, cnn.num_feat).astype(np.float32)
        ts["luts"][k] = lut / np.linalg.norm(lut, axis=1, keepdims=True)
    return ts


def jax_mesh_steps(states, devices=2):
    """grl_tpu's step on a ``devices``-device mesh from ``states[0]``."""
    cnn, siamese, unc = jax_models()
    step = j_make_train_step(cnn, siamese, unc, JSGD(), donate=False)
    mesh = j_data_mesh(devices)
    ts = j_replicate(jax.tree.map(jnp.asarray, states[0]), mesh)
    out, metrics_ = [states[0]], []
    for clips, targets, lr in batches():
        ts, m = step(ts, j_shard_batch(jnp.asarray(clips), mesh), j_shard_batch(jnp.asarray(targets, jnp.int32), mesh), lr)
        out.append(np_tree(ts))
        metrics_.append({k: float(v) for k, v in m.items()})
    return out, metrics_


def state_from(payload):
    return W.state_from_payload(payload)


def test_group_step_equals_grl_tpu_mesh_step(jax_run, group_run):
    """The port's 2-rank group step against grl_tpu's step on a 2-device
    mesh of the virtual CPU devices, leaf by leaf, for two steps."""
    states, metrics_ = jax_mesh_steps(jax_run[0])
    ranks = group_run["float32"][0]
    before = snapshot(port_state(states[0]))
    for i, (payload, m) in enumerate(ranks):
        state = state_from(payload)
        state.step = i + 1
        assert_state_matches(state, states[i + 1], f"group step {i + 1} vs grl_tpu's mesh", (before, states[i]),
                             lut_tol=CHAINED_LUT_TOL if i else LUT_TOL)
        for k, v in metrics_[i].items():
            if k.startswith("loss"):
                np.testing.assert_allclose(m[k], v, rtol=LOSS_RTOL, err_msg=f"step {i + 1} {k}")
        before = snapshot(state)


def test_group_step_refuses_a_state_with_local_batchnorm():
    """The group step checks, at its first call, that the CNN's BatchNorms
    are global (``parallel.sharded_train_state``); a plain state would
    normalize each rank's slice alone."""
    from grl_tpu_torch.engine import init_train_state

    state = init_train_state(*W.port_models(), 4, num_feat=8 * W.WIDTH * 4, device="cpu")
    step = make_train_step(device="cpu", mesh=parallel.Mesh(0, 1, "cpu"))
    with pytest.raises(ValueError, match="sharded_train_state"):
        step(state, torch.zeros(2, 2, 64, 32, 3), np.array([0, 0]), 1e-3)


# ---- the multi-process regime ----

MP = dict(catalog=dict(num_train_ids=16, num_test_ids=2, tracklets_per_id=2, height=64, width=32, seed=0),
          local_batch=4, seq_len=2, steps=2, lr=1e-3)


def test_multiprocess_regime_equals_one_process_replays(tmp_path):
    """2 ranks as grl_tpu's processes: each loads its identity shard at the
    local batch (disjoint pids, equal epoch lengths), and the state they end
    with equals one process replaying the assembled global batches (rank
    0's block, then rank 1's) through the port's ``Trainer`` and, from the
    port's augmented clips, through grl_tpu's step."""
    from grl_tpu.parallel import shard_catalog as j_shard
    from grl_tpu_torch.data import SyntheticVideoReID

    init = jax_init(MP["catalog"]["num_train_ids"])
    payload = W.state_payload(port_state(init))
    out = run(W.job_multiprocess_train, dict(MP, state=payload), tmp_path, multihost=True)
    r0, r1 = out
    assert len(r0["batches"]) == len(r1["batches"]) == MP["steps"]
    assert r0["epoch_len"] == r1["epoch_len"] > 0
    pids = [{int(p) for _, ids in r["batches"] for p in ids} for r in out]
    assert pids[0] and pids[1] and not pids[0] & pids[1]
    train = SyntheticVideoReID(**MP["catalog"]).train
    for rank, p in enumerate(pids):
        assert p <= {t[1] for t in j_shard(train, rank, 2)}
    assert r0["step_losses"] == r1["step_losses"]
    assert_payloads_close(r1["state"], r0["state"], dict(rtol=0, atol=0), dict(rtol=0, atol=0),
                          dict(rtol=0, atol=0), "rank 1 vs rank 0")

    glob = [(np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]])) for a, b in zip(r0["batches"], r1["batches"])]
    # the port's replay: one process, the global batches, the same Trainer seed
    state = W.state_from_payload(payload)
    losses = W.StepLosses()
    state, _ = Trainer(make_train_step(device="cpu"), losses, seed=0, print_freq=1000, device="cpu").train(
        0, state, [(c, p, p) for c, p in glob], MP["lr"])
    np.testing.assert_allclose(r0["step_losses"], losses.steps, rtol=1e-5)
    assert_payloads_close(r0["state"], W.state_payload(state), GROUP_PARAM_TOL, GROUP_STAT_TOL, LUT_TOL,
                          "multi-process vs the port's replay")

    # grl_tpu's replay, of the same augmented clips
    cnn, siamese, unc = jax_models()
    step = j_make_train_step(cnn, siamese, unc, JSGD(), donate=False)
    gen = torch.Generator().manual_seed(0)
    ts = jax.tree.map(jnp.asarray, init)
    for clips, ids in glob:
        x = augment(gen, torch.from_numpy(clips)).numpy()
        ts, _ = step(ts, jnp.asarray(x), jnp.asarray(ids, jnp.int32), MP["lr"])
    final = state_from(r0["state"])
    final.step = MP["steps"]
    assert_state_matches(final, np_tree(ts), "multi-process vs grl_tpu's replay", lut_tol=CHAINED_LUT_TOL)


DATA = dict(catalog=dict(num_train_ids=12, num_test_ids=2, tracklets_per_id=2, height=64, width=32, seed=4),
            batch=8, seq_len=2, epochs=2)


def test_sliced_data_path_equals_the_global_batch(tmp_path):
    """2 ranks load their slices of each global batch (``get_data`` with
    ``batch_slice``) and augment them (``augment(rows=)`` in the
    ``Trainer``): each step's rows, put side by side in rank order, are
    byte-equal to one process loading and augmenting the global batch, over
    two epochs (each epoch reshuffles and redraws)."""
    out = run(W.job_data_path, DATA, tmp_path)
    np.random.seed(0)
    _, _, loader, _, _ = get_data("synthetic", batch_size=DATA["batch"], seq_len=DATA["seq_len"], workers=2, seed=0,
                                  dataset_kwargs=DATA["catalog"])
    want = W.record_data_path(loader, DATA["epochs"])
    assert len(want) == len(out[0]) == len(out[1]) == DATA["epochs"] * len(loader) >= 4
    half = DATA["batch"] // 2
    for i, (clips, ids) in enumerate(want):
        assert clips.shape[0] == DATA["batch"] and out[0][i][0].shape[0] == half
        np.testing.assert_array_equal(np.concatenate([out[0][i][1], out[1][i][1]]), ids, err_msg=f"step {i} ids")
        np.testing.assert_array_equal(np.concatenate([out[0][i][0], out[1][i][0]]), clips, err_msg=f"step {i}")
    # the augmentation ran: some frames were erased (a solid box) or flipped
    plain = [c for c, _ in want[:len(loader)]]
    assert not all(np.array_equal(a, b) for a, b in zip(plain, [c for c, _ in want[len(loader):]]))


def test_stop_flag_on_one_rank_stops_both_at_the_same_step(tmp_path):
    """Rank 1 sets its stop flag after step 3 of a 25-step epoch: both ranks
    stop at the collective check of step 10, with both flags set; a flag
    set after the epoch's last check is resolved at the epoch's end."""
    out = run(W.job_stop, dict(rank=1, after=3, steps=25, epochs=5), tmp_path)
    assert [r["steps"] for r in out] == [10, 10] and all(r["stopped"] for r in out)
    assert [r["epochs"] for r in out] == [1, 1]
    out = run(W.job_stop, dict(rank=0, after=6, steps=6, epochs=5), tmp_path)
    assert [(r["steps"], r["epochs"]) for r in out] == [(6, 1), (6, 1)] and all(r["stopped"] for r in out)


# ---- striped evaluation ----

EVAL = dict(catalog=dict(num_train_ids=2, num_test_ids=5, tracklets_per_id=2, num_cams=2, frames_range=(2, 6),
                         seed=3),
            evaluator=dict(rerank=True, rerank_k1=5, rerank_k2=3))


def test_striped_evaluator_equals_one_process(tmp_path):
    """2 ranks each describe their stripe of the catalogs (5 queries: the
    stripes do not divide, rank 1's ends in a pad row); the re-ranked
    distance matrix, rank-1 and mAP equal one process's on every rank."""
    out = run(W.job_evaluate, EVAL, tmp_path)
    dataset, _, _, q, g = get_data("synthetic", seq_len=2, workers=1, only_eval=True, dataset_kwargs=EVAL["catalog"])
    assert len(dataset.query) % 2 == 1 and out[1]["stripe"] == out[0]["stripe"]
    res = Evaluator(*W.eval_models(), micro_batch=4, device="cpu", **EVAL["evaluator"]).evaluate(q, g)
    for r in out:
        np.testing.assert_allclose(r["qf"], res.qf.numpy(), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["distmat"], res.distmat.numpy(), atol=1e-5)
        np.testing.assert_array_equal(r["cmc"], res.cmc)
        assert r["mAP"] == res.mAP
    assert os.path.isdir(tmp_path)
