"""The port's CLIs over two gloo ranks on the CPU (``--devices 2 --device
cpu``), against the same CLIs on one process.

Each CLI runs as ``python -m grl_tpu_torch.cli.<name>`` in its own process
session under a timeout, past which the session (the CLI and the ranks it
launched) is killed and the test fails. Every process runs one thread
(``OMP_NUM_THREADS=1``; the launched ranks take one each anyway), so one
rank and two reduce alike and a loaded host does not oversubscribe its
cores. The models are ``--tiny``, the catalog synthetic (64x32 frames, 2
frames a clip).

Bounds, each beside its comparison:
- ``cli.train --devices 2`` against ``--devices 1`` over one epoch of four
  steps at ``--lr 0``: the parameters stay where the seed put them, so no
  step amplifies the reductions' rounding into the next, and every step
  compares the data path (each rank's slice, its augmentation) and the
  group step at the same weights. fp32: every step's loss within rtol
  1e-5 (read: 1.4e-6), the parameters equal, the luts, BN statistics and
  momentum (the gradients summed over the steps) within a relative L2 of
  1e-3, 1e-4 and 1e-3 of the one-rank run's (read: 1.9e-5, 6.8e-7,
  8.7e-5). ``tests/test_torch_parallel.py`` holds the step with updates;
- ``--bf16``: the losses within rtol 1e-2, the parameters equal, luts,
  statistics and momentum within 0.1, 1e-2 and 0.6 (read: 3.4e-3; 0.032,
  1.0e-3, 0.26; the one-rank run on eight threads instead of one is as far
  from it: bf16 products round differently with the batch split and the
  threads);
- ``cli.evaluate`` and ``extract features``: rank-1 equal, features
  within 1e-5.
"""

import json
import os
import os.path as osp
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
TIMEOUT = 150  # seconds for one CLI run, its ranks included
TRAIN = ["-d", "synthetic", "--tiny", "-b", "4", "--seq_len", "2", "--synthetic-ids", "2", "-j", "1",
         "--device", "cpu"]
FROZEN = [*TRAIN, "--epochs", "1", "--lr", "0"]


def cli(name, *argv, timeout=TIMEOUT, env=None):
    """``python -m grl_tpu_torch.cli.<name> argv`` on one thread; its output.
    A run past ``timeout`` is killed with its ranks and fails the test."""
    proc = subprocess.Popen([sys.executable, "-m", f"grl_tpu_torch.cli.{name}", *argv], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, start_new_session=True,
                            env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})})
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"cli.{name} {argv} did not finish in {timeout} s:\n{out[-4000:]}")
    assert proc.returncode == 0, out[-4000:]
    return out


def scalars(logs):
    with open(osp.join(logs, "train_log", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def step_losses(logs):
    return [s["value"] for s in scalars(logs) if s["tag"] == "train/total_loss_step"]


def checkpoint_groups(path):
    """A checkpoint's leaves grouped by the top-level key of its tree
    (``params``, ``luts``, ``model_state``, ``opt``, ...), in file order."""
    data = np.load(path)
    counts, depth, key = {}, 0, None
    for tok in re.findall(r"[{}()]|'[^']*'(?=: )|\*", str(data["treedef"])[len("PyTreeDef("):]):
        if tok in "{(":
            depth += 1
        elif tok in "})":
            depth -= 1
        elif tok == "*":
            counts[key] = counts.get(key, 0) + 1
        elif depth == 1:
            key = tok.strip("'")
    leaves = sorted(k for k in data.files if k.startswith("leaf_"))
    assert sum(counts.values()) == len(leaves)
    out, i = {}, 0
    for key, n in counts.items():
        out[key] = [data[k] for k in leaves[i:i + n]]
        i += n
    return out


def relative_l2(got, want):
    flat = lambda leaves: np.concatenate([np.ravel(v).astype(np.float64) for v in leaves])
    got, want = flat(got), flat(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    logs = str(tmp_path_factory.mktemp("one_rank"))
    cli("train", *FROZEN, "--devices", "1", "--logs-dir", logs)
    return logs


@pytest.mark.parametrize("extra,loss_rtol,group_tol", [
    ([], 1e-5, dict(luts=1e-3, model_state=1e-4, opt=1e-3)),
    (["--bf16"], 1e-2, dict(luts=0.1, model_state=1e-2, opt=0.6)),
], ids=["fp32", "bf16"])
def test_cli_train_on_two_ranks_equals_one(tmp_path, one_rank, extra, loss_rtol, group_tol):
    """One epoch at ``--lr 0`` on 2 ranks against 1, within the bounds of
    the module docstring (``--bf16``: against its own one-rank run). Rank 0
    alone writes the checkpoints and the scalars; rank 1 logs to its
    ``.p1`` file."""
    ref = one_rank
    if extra:
        ref = str(tmp_path / "one")
        cli("train", *FROZEN, *extra, "--devices", "1", "--logs-dir", ref)
    logs = str(tmp_path / "two")
    out = cli("train", *FROZEN, *extra, "--devices", "2", "--logs-dir", logs)
    assert "Mesh(rank=0, size=2" in out and "Mesh(rank=1, size=2" in out
    assert sorted(p for p in os.listdir(logs) if p.startswith("log_")) == ["log_train0.p1.txt", "log_train0.txt"]
    assert "checkpoint.npz" in os.listdir(logs)
    assert [(s["tag"], s["step"]) for s in scalars(logs)] == [(s["tag"], s["step"]) for s in scalars(ref)]
    two, one = step_losses(logs), step_losses(ref)
    assert len(two) == len(one) == 4
    np.testing.assert_allclose(two, one, rtol=loss_rtol)
    got, want = (checkpoint_groups(osp.join(d, "checkpoint.npz")) for d in (logs, ref))
    assert sorted(got) == sorted(want) and len(want["params"]) > 100
    for a, b in zip(got["params"], want["params"]):
        np.testing.assert_array_equal(a, b)
    for key, tol in group_tol.items():
        d = relative_l2(got[key], want[key])
        assert d <= tol, f"{key}: relative L2 {d} (bound {tol})"


def test_cli_evaluate_on_two_ranks_equals_one(tmp_path, one_rank):
    """``cli.evaluate --rerank 1`` on 2 ranks, each describing its stripe,
    against one process on the same checkpoint: rank 0's report."""
    common = ["-d", "synthetic", "--tiny", "--seq_len", "2", "--synthetic-ids", "2", "-j", "1", "--seed", "0",
              "--checkpoint", osp.join(one_rank, "checkpoint.npz"), "--rerank", "1", "--device", "cpu"]
    report = {}
    for n in (1, 2):
        logs = tmp_path / f"eval{n}"
        cli("evaluate", *common, "--devices", str(n), "--logs-dir", str(logs))
        text = (logs / "log_test0.txt").read_text()
        report[n] = [line for line in text.splitlines() if line.startswith(("rank-1 accuracy", "Mean AP", "Rank-"))]
    assert "Mesh(rank=1, size=2" in (tmp_path / "eval2" / "log_test0.p1.txt").read_text()
    assert len(report[1]) >= 3 and report[2] == report[1]


def test_extract_features_on_two_ranks_equals_one(tmp_path, one_rank):
    """``extract features`` on 2 ranks: rank 0 writes the stripes' rows in
    catalog order, equal to one process's file."""
    feats = {}
    for n in (1, 2):
        path = str(tmp_path / f"gallery{n}.npz")
        cli("extract", "--device", "cpu", "features", "-d", "synthetic", "--tiny", "--seq_len", "2",
            "--synthetic-ids", "2", "-j", "1", "--seed", "0", "--checkpoint", osp.join(one_rank, "checkpoint.npz"),
            "--split", "gallery", "--devices", str(n), "-o", path)
        feats[n] = np.load(path)
    for k in ("pids", "camids"):
        np.testing.assert_array_equal(feats[2][k], feats[1][k])
    np.testing.assert_allclose(feats[2]["features"], feats[1]["features"], rtol=0, atol=1e-5)


def test_sigterm_to_a_two_rank_train_checkpoints_once(tmp_path):
    """SIGTERM to the launching process, once both ranks train: it reaches
    both ranks, they stop together at a collective check, rank 0
    checkpoints once (the epoch they stopped in), and the run exits 0."""
    logs = tmp_path / "run"
    # 16 ids: 16 steps an epoch, so the signal lands inside epoch 0
    proc = subprocess.Popen([sys.executable, "-m", "grl_tpu_torch.cli.train", *TRAIN, "--synthetic-ids", "16",
                             "--devices", "2", "--epochs", "400", "--ckpt-freq", "1000", "--logs-dir", str(logs)],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        deadline = time.time() + TIMEOUT
        ready = lambda: all((logs / f).exists() and "0.001" in (logs / f).read_text().split("==========")[-1]
                            for f in ("log_train0.txt", "log_train0.p1.txt"))
        while not ready():
            assert proc.poll() is None and time.time() < deadline, "the ranks never started training"
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, out[-4000:]
    assert out.count("state saved to") == 1, out[-4000:]
    assert sorted(p.name for p in logs.iterdir() if p.name.startswith("checkpoint")) == ["checkpoint.npz"]
    assert int(np.load(logs / "checkpoint.npz")["extra_epoch"]) == 0
    rank1 = (logs / "log_train0.p1.txt").read_text()
    assert "signal 15" in rank1 and "rank 0 saves the state" in rank1
