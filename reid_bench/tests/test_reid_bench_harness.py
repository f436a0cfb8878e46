"""The harness at small sizes on the CPU: each cell's run end to end, its
result line, seeded traffic, a cell found from a dropped file, the check
for JAX, and runs whose timed path is broken underneath coming out not
correct."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from reid_bench import run
from reid_bench.tests.conftest import tiny
from reid_bench.trace import Spans
from reid_bench.traffic import dense_index, frames, pair_train, rerank_open_loop

ROOT = Path(run.__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 12345  # more than 32 signed bits hold
KIND = {w["name"]: w["traffic"] for w in BENCH["workloads"]}


def execute(cell, trace=0, seconds=0.5, seed=SEED):
    return run.execute(cell, seed, seconds, trace, "cpu", overrides=tiny(KIND[cell]))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_and_is_correct(cell):
    result, _ = execute(cell)
    assert result["correct"] and list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in BENCH["end_to_end"]
                                      if cell in m.get("workloads", [cell])}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("cell", ["grl_r50_mars.index", "grl_r50_mars.train"])
def test_traced_run_reports_its_layers(cell):
    result, _ = execute(cell, trace=1)
    listed = {m["name"] for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == listed
    assert result["device"]["busy_s"] > 0 and result["device"]["window_s"] > 0
    assert len(result["breakdown"]["device_ops"]) <= 10 and result["breakdown"]["idle_gaps"]


def test_traffic_is_seeded():
    a = frames.frame_pool(7, 40, 16, 8, 8, 0.08, "cpu")
    assert np.array_equal(a, frames.frame_pool(7, 40, 16, 8, 8, 0.08, "cpu"))
    assert not np.array_equal(a, frames.frame_pool(8, 40, 16, 8, 8, 0.08, "cpu"))
    p = tiny("dense_index")["params"]
    p.update(run.workload("grl_r50_mars.index")["params"] | p)
    lengths = dense_index.plan_lengths(p, 4)
    assert np.array_equal(lengths, dense_index.plan_lengths(p, 4))
    assert sum(dense_index.clip_count(n, 4) for n in lengths) % p["micro_batch"] == 0
    sp = run.workload("grl_r50_mars.rerank")["params"]
    one = rerank_open_loop.schedule(sp, 30, np.random.RandomState(1))
    assert one == rerank_open_loop.schedule(sp, 30, np.random.RandomState(1))
    other = rerank_open_loop.schedule(sp, 30, np.random.RandomState(2))
    assert one != other and sorted(q for _, q in one) == sorted(q for _, q in other)
    cfg = dict(run.config("grl_r50_mars"), num_train_tracklets=50, num_train_ids=7)
    pool = frames.frame_pool(1, 600, 8, 8, 8, 0.08, "cpu")
    tp = run.workload("grl_r50_mars.train")["params"]
    c1 = pair_train.catalog(cfg, tp, pool, np.random.RandomState(3))
    c2 = pair_train.catalog(cfg, tp, pool, np.random.RandomState(3))
    assert all(np.array_equal(x, y) for x, y in zip(c1[1:], c2[1:]))


def test_a_dropped_cell_and_metric_are_found(tmp_path):
    shutil.copytree(ROOT / "reid_bench", tmp_path / "reid_bench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    src = json.loads((ROOT / "reid_bench/workloads/grl_r50_mars.index.json").read_text())
    (tmp_path / "reid_bench/workloads/grl_r50_mars.index_short.json").write_text(
        json.dumps(dict(src, params=dict(src["params"], length_mean=16))))
    (tmp_path / "reid_bench/metrics/clips.index.py").write_text(
        "def read(run):\n    return run.counters.get('clips')\n")
    bench["workloads"].append({"name": "grl_r50_mars.index_short", "config": "grl_r50_mars",
                               "traffic": "dense_index", "chips": 1, "why": "short tracklets"})
    bench["per_layer"].append({"name": "clips.index", "unit": "clips", "better": "higher",
                               "source": "program_counter", "layer": "data", "moves": "describe_clips_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; from reid_bench import run; from reid_bench.tests.conftest import tiny; "
            "r, _ = run.execute('grl_r50_mars.index_short', 3, 0.3, 1, 'cpu', overrides=tiny('dense_index')); "
            "print(json.dumps(r))")
    env = {"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["clips.index"]["value"] > 0


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    import reid_bench.run as harness

    assert harness.forbidden_modules() == [] or "grl_tpu" not in sys.modules
    monkeypatch.setitem(sys.modules, "grl_tpu_torch_extra", object())
    assert "grl_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "grl_tpu.models", object())
    assert harness.forbidden_modules() == ["grl_tpu"]
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert harness.forbidden_modules() == ["grl_tpu", "jaxlib"]


def test_the_command_refuses_without_its_chips():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "reid_bench", "--workload", "grl_r50_mars.index", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


# -- the timed path broken underneath -----------------------------------------------
def _reverse_descriptors(monkeypatch):
    """An answer altered where it is produced: each dispatch's descriptors in reverse order."""
    import grl_tpu_torch.engine.evaluator as ev

    real = ev.make_descriptor_fn
    monkeypatch.setattr(ev, "make_descriptor_fn", lambda cnn, sia: (lambda c: real(cnn, sia)(c).flip(0)))


def _half_the_clips(monkeypatch):
    """Half of each tracklet's clips left out, the mean taken over the rest."""
    import grl_tpu_torch.data.loader as loader

    real = loader.dense_indices
    monkeypatch.setattr(loader, "dense_indices", lambda n, s: real(n, s)[: max(len(real(n, s)) // 2, 1)])


def _unchanged_state(monkeypatch):
    """A step that returns its state unchanged."""
    from grl_tpu_torch.engine import optim

    monkeypatch.setattr(optim.SGD, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    import grl_tpu_torch.engine.train_step as ts

    real = ts.grl_loss_fn

    def half(models, luts, clips, targets, **kw):
        b = clips.shape[0] // 2
        return real(models, luts, clips[:b], targets[:b], **kw)

    monkeypatch.setattr(ts, "grl_loss_fn", half)


@pytest.mark.parametrize("cell,fault", [
    ("grl_r50_mars.index", _reverse_descriptors),
    ("grl_r50_mars.index", _half_the_clips),
    ("grl_r50_mars.train", _unchanged_state),
    ("grl_r50_mars.train", _half_the_batch),
])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = execute(cell)
    assert not result["correct"]


def test_an_altered_answer_from_the_daemon_is_not_correct(tmp_path, monkeypatch):
    """The daemon's re-ranked distances altered where they are produced
    (a ``sitecustomize`` in the daemon's process)."""
    (tmp_path / "sitecustomize.py").write_text(
        "import grl_tpu_torch.cli.extract as ex\n"
        "real = ex.re_ranking_padded\n"
        "def altered(*a, **k):\n"
        "    d = real(*a, **k)\n"
        "    return d + 0.05 * (d.argsort(dim=1).argsort(dim=1) % 2)\n"
        "ex.re_ranking_padded = altered\n")
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{ROOT}")
    result, _ = execute("grl_r50_mars.rerank")
    assert not result["correct"]


def test_a_shifted_top_k_from_the_daemon_is_not_correct(tmp_path, monkeypatch):
    """The daemon's top-k altered where it is produced: each row's items
    ranked 2nd to (k+1)th served, each at its own true score."""
    (tmp_path / "sitecustomize.py").write_text(
        "import grl_tpu_torch.cli.extract as ex\n"
        "real = ex.top_k\n"
        "def shifted(x, k):\n"
        "    values, idx = real(x, k + 1)\n"
        "    return values[:, 1:], idx[:, 1:]\n"
        "ex.top_k = shifted\n")
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{ROOT}")
    result, _ = execute("grl_r50_mars.rerank")
    assert not result["correct"]


def test_the_check_counts_each_kind_of_wrong_top_k_entry():
    ref = np.array([[0.1, 0.2, 0.3, 0.4, 0.5]])
    good = np.array([[0, 1, 2]])
    assert rerank_open_loop.off_entries(good, ref[:, :3], ref) == (0, 3)
    for order, dist in (([[0, 1, 3]], [[0.1, 0.2, 0.4]]),  # not among the top 3
                        ([[0, 1, 1]], [[0.1, 0.2, 0.2]]),  # a repeat
                        ([[0, 1, -1]], [[0.1, 0.2, np.nan]]),  # missing
                        ([[0, 1, 2]], [[0.1, 0.2, 0.31]])):  # the right item at a wrong distance
        assert rerank_open_loop.off_entries(np.array(order), np.array(dist), ref) == (1, 3)
    resp = {"results": [{"matches": [{"gallery": 0, "score": -0.1}, {"gallery": 1, "score": -0.2}]}]}
    order, scores = rerank_open_loop.served(resp, 2, 3)
    assert rerank_open_loop.off_entries(order, -scores, np.vstack([ref, ref])) == (4, 6)


def test_jax_loaded_in_the_daemon_gives_no_result(tmp_path, monkeypatch, capsys):
    """JAX loaded in the daemon's process (a ``sitecustomize`` there): the
    run reports it and the command prints no result."""
    (tmp_path / "sitecustomize.py").write_text("import sys, types\nsys.modules['jax'] = types.ModuleType('jax')\n")
    monkeypatch.setenv("PYTHONPATH", f"{tmp_path}:{ROOT}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    seen = []
    real = run.execute

    def on_the_cpu(name, seed, seconds, trace, device, t0=None):
        result, out = real(name, seed, seconds, trace, "cpu", t0=t0, overrides=tiny(KIND[name]))
        seen.append(out.forbidden)
        return result, out

    monkeypatch.setattr(run, "execute", on_the_cpu)
    assert "jax" not in sys.modules
    code = run.main(["--workload", "grl_r50_mars.rerank", "--seed", str(SEED), "--seconds", "0.5", "--trace", "0"])
    captured = capsys.readouterr()
    assert seen == [["jax"]] and code != 0 and captured.out.strip() == ""
    assert "jax in the system's other processes" in captured.err


@pytest.mark.parametrize("cell", ["grl_r50_mars.index", "grl_r50_mars.train", "grl_r50_mars.rerank"])
def test_the_control_is_not_correct(cell):
    """The reference put in the program's place at the precision below the
    cell's fails its limits (float8 operands for bf16; TF32 for fp32)."""
    from reid_bench.control import CONTROLS

    wl = run.workload(cell)
    kind = {"dense_index": dense_index, "pair_train": pair_train, "rerank_open_loop": rerank_open_loop}[wl["traffic"]]
    o = tiny(wl["traffic"])
    cfg = dict(run.config(wl["config"]), **o["config"])
    wl["params"].update(o["params"])
    ctx = run.Context(cell, wl, cfg, SEED, 0.5, False, "cpu", 0.0, Spans())
    out = kind.run(ctx, **CONTROLS[wl["traffic"]])
    readings = out.control if wl["traffic"] != "pair_train" else out.control["tf32"]
    assert any(readings[k] > limit for k, (_, limit) in out.checks.items() if k in readings)
