"""The port's three measurement tools (``grl_tpu_torch/tools``) on the CPU.

Each runs as ``python -m grl_tpu_torch.tools.<name> ... --device cpu`` (or
with no device, for the checkpoint writer) in its own process session
under a timeout, past which it is killed and the test fails.
"""

import json
import os
import os.path as osp
import signal
import subprocess
import sys

import numpy as np
import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TIMEOUT = 180


def tool(name, *argv):
    # two threads: the tools share the host with the other test workers
    proc = subprocess.Popen([sys.executable, "-m", f"grl_tpu_torch.tools.{name}", *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
                            env={**os.environ, "OMP_NUM_THREADS": "2"})
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"tools.{name} did not finish in {TIMEOUT} s:\n{out[-3000:]}\n{err[-3000:]}")
    assert proc.returncode == 0, f"{out[-3000:]}\n{err[-3000:]}"
    return out


def last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_make_random_checkpoint_reads_in_both_packages(tmp_path):
    """``--tiny`` writes a train state that grl_tpu's and the port's
    ``load_train_state`` both read into their tiny models (4 classes)."""
    import jax

    from grl_tpu.cli.train import build_models as j_build
    from grl_tpu.engine.optim import SGD
    from grl_tpu.engine.train_step import init_train_state as j_init
    from grl_tpu.utils.serialization import load_train_state as j_load
    from grl_tpu_torch.cli.train import build_models
    from grl_tpu_torch.engine import init_train_state
    from grl_tpu_torch.utils import load_train_state
    from types import SimpleNamespace

    path = str(tmp_path / "ckpt" / "checkpoint_best.npz")
    out = tool("make_random_checkpoint", "-o", path, "--tiny", "--num-classes", "4")
    assert "4 classes, tiny" in out
    cnn, sia, unc = j_build(SimpleNamespace(bf16=False, use_flow=False, arch2="siamese"), tiny=True)
    jstate, extras = j_load(j_init(jax.random.PRNGKey(1), cnn, sia, unc, 4, cnn.num_feat, SGD()), path)
    assert int(extras["epoch"]) == 0 and float(extras["best_top1"]) == 0.0
    state = init_train_state(*build_models(SimpleNamespace(arch2="siamese", seed=5), tiny=True), 4, num_feat=128,
                             device="cpu")
    assert int(load_train_state(state, path)["epoch"]) == 0
    conv1 = state.models["cnn"].backbone.base.conv1.weight.detach().numpy()
    np.testing.assert_array_equal(conv1, np.transpose(
        np.asarray(jstate["params"]["cnn"]["backbone"]["base"]["conv1"]["kernel"]), (3, 2, 0, 1)))
    assert state.luts["corr"].shape == (4, 128)


@pytest.mark.parametrize("clients,rank_every", [(3, 0), (3, 2)], ids=["describe", "describe+rank"])
def test_measure_serve_concurrency_prints_its_line(clients, rank_every):
    """A tiny artifact, one daemon in the tool's process: the same number of
    one-clip requests in turn and from ``clients`` connections; the
    concurrent run packs clips of several requests into one dispatch; each
    phase's coalescer timeline, a second pass with the probe on, accounts
    for every dispatch and request of that pass."""
    report = last_json(tool("measure_serve_concurrency", "--device", "cpu", "--clients", str(clients), "--reps", "3",
                            "--batch", "4", "--seq_len", "2", "--rank-every", str(rank_every)))
    assert report["device"] == "cpu" and report["total_clips"] == clients * 3
    seq, conc = report["sequential"], report["concurrent"]
    assert seq["clips"] == conc["clips"] == clients * 3 and seq["packed"] == 0
    assert conc["packed"] > 0 and conc["dispatches"] < seq["dispatches"]
    assert report["dispatch_reduction"] > 1 and seq["wall_s"] > 0 and conc["wall_s"] > 0
    # the timeline: one call and one lead per dispatch, every request's wait
    # and hand-off, one turnaround less per connection than its requests
    for ph, connections in ((seq, 1), (conc, clients)):
        t = ph["timeline"]
        assert t["clips"] == clients * 3 and t["wall_s"] > 0 and "timeline" not in t
        assert t["dispatch_s"]["n"] == t["dispatch_cpu_s"]["n"] == t["lead_s"]["n"] == t["dispatches"]
        assert t["gap_s"]["n"] == t["dispatches"] - 1
        assert t["wait_s"]["n"] == t["handoff_s"]["n"] == clients * 3
        assert t["turnaround_s"]["n"] == clients * 3 - connections
        assert 0 <= t["handoff_s"]["max"] and t["dispatch_s"]["max"] <= t["lead_s"]["max"]


def test_measure_serve_concurrency_daemon_runs_under_the_policy(tmp_path):
    """``--model`` of an artifact exported in another process: no CLI
    ``main`` runs in the tool's process, yet its daemon thread reads every
    flag of the CLIs' precision policy off (PyTorch's default leaves
    cuDNN's TF32 on), as the tool's ``main`` fixed them."""
    from grl_tpu_torch import precision_flags

    ckpt = str(tmp_path / "ckpt.npz")
    tool("make_random_checkpoint", "-o", ckpt, "--tiny", "--num-classes", "4")
    model = str(tmp_path / "model.npz")
    export = subprocess.run([sys.executable, "-m", "grl_tpu_torch.cli.extract", "--device", "cpu", "export-model",
                             "--checkpoint", ckpt, "--tiny", "--num-classes", "4", "--batch", "4", "--seq_len", "2",
                             "--height", "64", "--width", "32", "-o", model], cwd=REPO, capture_output=True,
                            text=True, timeout=TIMEOUT, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert export.returncode == 0, export.stderr[-3000:]
    report = last_json(tool("measure_serve_concurrency", "--device", "cpu", "--model", model, "--clients", "2",
                            "--reps", "2"))
    assert report["batch"] == 4 and report["concurrent"]["clips"] == 4
    assert sorted(report["daemon_precision_flags"]) == sorted(precision_flags())
    assert not any(report["daemon_precision_flags"].values()), report["daemon_precision_flags"]


def test_rehearse_mars_scale_prints_its_line(tmp_path):
    """8 train and 8 test ids of MARS's layout over 2 cameras, 48x24 JPEGs:
    one epoch of ``cli.train -d mars --tiny`` and ``cli.evaluate``, with the
    catalog's cardinality, the frame size asked for, and the epoch's mean
    step and data-wait seconds."""
    report = last_json(tool("rehearse_mars_scale", str(tmp_path / "mars"), "--device", "cpu", "--train-ids", "8",
                            "--test-ids", "8", "--cams", "2", "--query-cams", "1", "--height", "48", "--width", "24"))
    assert report["device"] == "cpu" and report["frame"] == [48, 24] and report["full_width"] is False
    from PIL import Image

    frame = next(p for p in (tmp_path / "mars" / "bbox_train").rglob("*.jpg"))
    assert Image.open(frame).size == (24, 48)
    assert report["train_batch_s"] > 0 and report["train_data_s"] >= 0
    assert report["train_tracklets"] == 8 * 2 * 2
    assert report["query_tracklets"] == 8 and report["gallery_tracklets"] == 8 * 2 * 3 - 8
    assert report["train_steps"] == 2 * 32 // 16
    for k in ("generate_s", "train_epoch_s", "eval_s", "max_rss_mb"):
        assert report[k] > 0
    assert 0.0 <= report["eval_top1"] <= 1.0
    assert osp.exists(tmp_path / "mars" / "run" / "checkpoint.npz")


def test_bench_scaling_runs_widths_1_and_2():
    """``--tiny --device cpu --devices 2``: the group step at one and two
    gloo ranks, the global batch doubling, one line per width and the JSON
    line (CPU times share the host: only their presence is checked)."""
    out = tool("bench_scaling", "--tiny", "--device", "cpu", "--devices", "2", "--iters", "2", "--seq_len", "2")
    rows = last_json(out)["scaling"]
    assert [r["devices"] for r in rows] == [1, 2] and [r["global_batch"] for r in rows] == [8, 16]
    assert rows[0]["weak_scaling_eff"] == 1.0 and all(r["ms_per_step"] > 0 and np.isfinite(r["loss"]) for r in rows)
    assert out.count("weak-scaling eff") == 2


@pytest.mark.parametrize("argv", [["--rerank"], ["--lsvid", "--rerank", "--from-host", "--warm"], []],
                         ids=["mars_rerank", "lsvid_from_host_warm", "mars"])
def test_bench_eval_tail_one_rank_equals_two(monkeypatch, argv):
    """The tool at sizes shrunk through ``SIZES`` (MARS 30 x 100, LS-VID 40 x
    130): on one process and on 2 gloo ranks (the tail sharded), the same
    rank-1 and mAP; each re-ranking pass launches one slab per process."""
    from grl_tpu_torch.tools import bench_eval_tail

    monkeypatch.setattr(bench_eval_tail, "SIZES", {"MARS": (30, 70), "LS-VID": (40, 90)})
    one = bench_eval_tail.main(["--device", "cpu", "--dim", "32", *argv])
    two = bench_eval_tail.main(["--device", "cpu", "--dim", "32", "--devices", "2", *argv])
    assert len(one) == 1 and len(two) == 2
    for r in two:
        assert len(r["passes"]) == len(one[0]["passes"]) == (2 if "--warm" in argv else 1)
        for got, want in zip(r["passes"], one[0]["passes"]):
            assert got["rank1"] == want["rank1"] and abs(got["mAP"] - want["mAP"]) <= 1e-6
            assert got["launches"] == want["launches"] == (1 if "--rerank" in argv else 0)
            assert got["peak_gib"] is None and got["seconds"] > 0
