"""The port's train and evaluate CLIs on the CPU (``--device cpu``), against
grl_tpu's.

Tiny runs as ``tests/test_cli.py``: ``-d synthetic --tiny -b 4 --seq_len 2``
(64x32 frames, trunk width 4). A checkpoint written by one package's CLI
is read by the other's; the re-ranked distance matrices of the two
evaluate CLIs on one checkpoint agree within 1e-4 absolute (fp32
descriptors of two frameworks, then grl_tpu's host re-ranking against the
port's device re-ranking), ids exactly.
"""

import json
import re
import signal
import sys

import numpy as np
import pytest

from grl_tpu.cli import evaluate as j_eval
from grl_tpu.cli import train as j_train
from grl_tpu_torch.cli import evaluate as t_eval
from grl_tpu_torch.cli import train as t_train

TINY = ["-d", "synthetic", "--tiny", "--seq_len", "2", "-j", "2"]
DISTMAT_ATOL = 1e-4


def run(module, argv, port=True):
    """``module.main`` on parsed ``argv`` (the port's on the CPU), with
    ``sys.stdout`` restored after the tee logger replaced it."""
    args = module.build_parser().parse_args(argv + (["--device", "cpu"] if port else []))
    stdout = sys.stdout
    try:
        return module.main(args)
    finally:
        sys.stdout = stdout


def train(logs, *extra, port=True):
    return run(t_train if port else j_train, TINY + ["-b", "4", "--logs-dir", str(logs), *extra], port)


def epoch_losses(logfile):
    pat = re.compile(r"^epoch (\d+): loss ([0-9.]+)")
    return {int(m.group(1)): float(m.group(2)) for m in map(pat.match, open(logfile)) if m}


def scalars(logs):
    return [json.loads(line) for line in open(logs / "train_log" / "scalars.jsonl")]


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """Two epochs of the port's CLI (the final epoch evaluates and checkpoints)."""
    logs = tmp_path_factory.mktemp("port") / "run"
    top1 = train(logs, "--epochs", "2")
    return logs, top1


def test_train_resume_evaluate(port_run, tmp_path):
    logs, top1 = port_run
    assert 0.0 < top1 <= 1.0
    for name in ("checkpoint.npz", "checkpoint_best.npz", "log_train0.txt"):
        assert (logs / name).exists(), name
    assert int(np.load(logs / "checkpoint.npz")["extra_epoch"]) == 2
    log = (logs / "log_train0.txt").read_text()
    assert "device: cpu" in log and "Mean AP" in log and list(epoch_losses(logs / "log_train0.txt")) == [0, 1]
    steps = len([s for s in scalars(logs) if s["tag"] == "train/total_loss_step"])
    assert steps % 2 == 0 and steps >= 2

    # resume in a copy of the run: exactly one more epoch, scalars appended
    import shutil

    resumed = tmp_path / "resumed"
    shutil.copytree(logs, resumed)
    train(resumed, "--epochs", "3", "--resume", str(resumed / "checkpoint.npz"))
    assert list(epoch_losses(resumed / "log_train1.txt")) == [2]
    assert "resumed from" in (resumed / "log_train1.txt").read_text()
    assert int(np.load(resumed / "checkpoint.npz")["extra_epoch"]) == 3
    records = scalars(resumed)
    assert len(records) == 2 * steps * 3 // 2 and records[-1]["step"] == 3 * steps // 2 - 1

    top1_eval = run(t_eval, TINY + ["--logs-dir", str(resumed), "--seed", "0"])
    assert 0.0 <= top1_eval <= 1.0
    assert "Mean AP" in (resumed / "log_test0.txt").read_text()


def test_scalars_have_grl_tpu_tags_and_steps(port_run, tmp_path):
    logs, _ = port_run
    theirs = tmp_path / "jax"
    train(theirs, "--epochs", "2", port=False)
    key = lambda recs: [(r["tag"], r["step"]) for r in recs]
    assert key(scalars(logs)) == key(scalars(theirs))
    assert {r["tag"] for r in scalars(logs)} == {"train/total_loss_step", "train/total_loss_avg"}
    # a grl_tpu checkpoint resumes in the port's CLI
    train(theirs, "--epochs", "3", "--resume", str(theirs / "checkpoint.npz"))
    assert list(epoch_losses(theirs / "log_train1.txt")) == [2]
    assert int(np.load(theirs / "checkpoint.npz")["extra_epoch"]) == 3


def test_one_checkpoint_through_both_evaluate_clis(port_run, tmp_path):
    logs, _ = port_run
    argv = TINY + ["--logs-dir", str(tmp_path), "--checkpoint", str(logs / "checkpoint.npz"),
                   "--rerank", "1", "--seed", "0"]
    run(j_eval, argv + ["--save-distmat", str(tmp_path / "jax.npz")], port=False)
    run(t_eval, argv + ["--save-distmat", str(tmp_path / "port.npz")])
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in ("q_pids", "q_camids", "g_pids", "g_camids", "rerank"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert bool(got["rerank"]) and got["distmat"].shape == want["distmat"].shape
    np.testing.assert_allclose(got["distmat"], want["distmat"], rtol=0, atol=DISTMAT_ATOL)


def test_sigterm_preemption_checkpoints_and_resumes(tmp_path, monkeypatch):
    """SIGTERM at the start of epoch 1 (raised from ``step_decay_lr``, which
    ``main`` calls once per epoch): the run stops at the step boundary,
    checkpoints "redo epoch 1" and returns; ``--resume`` replays epoch 1."""
    logs = tmp_path / "pre"
    orig = t_train.step_decay_lr

    def hooked(lr, epoch, step):
        if epoch == 1:
            signal.raise_signal(signal.SIGTERM)
        return orig(lr, epoch, step)

    monkeypatch.setattr(t_train, "step_decay_lr", hooked)
    train(logs, "--epochs", "4")
    monkeypatch.setattr(t_train, "step_decay_lr", orig)
    assert int(np.load(logs / "checkpoint.npz")["extra_epoch"]) == 1
    log = (logs / "log_train0.txt").read_text()
    assert "preempted during epoch 1" in log and "stop requested" in log
    assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL, signal.default_int_handler)

    train(logs, "--epochs", "2", "--resume", str(logs / "checkpoint.npz"))
    assert list(epoch_losses(logs / "log_train1.txt")) == [1]
    assert int(np.load(logs / "checkpoint.npz")["extra_epoch"]) == 2


@pytest.mark.parametrize("extra", [
    ["--dropout", "0.5"], ["--sampling-rate", "5"], ["--features", "512"], ["--arch1", "resnet50"],
    ["--ckpt-freq", "0"], ["--use-flow"], ["--sample_method", "window"],
], ids=lambda e: e[0])
def test_validate_args_rejects_what_grl_tpu_rejects(extra):
    base = ["-d", "synthetic", "--tiny"]
    with pytest.raises(SystemExit):
        j_train.validate_args(j_train.build_parser().parse_args(base + extra))
    with pytest.raises(SystemExit):
        t_train.validate_args(t_train.build_parser().parse_args(base + extra))


@pytest.mark.parametrize("module,extra,item", [
    (t_train, ["--devices", "2"], 7),
    (t_train, ["-d", "ilidsvidsequence", "--use-flow"], None), (t_train, ["--visual", "1"], None),
    (t_eval, ["--visual-from", "dist.npz"], None),
], ids=["devices", "use-flow", "visual", "visual-from"])
def test_unported_flags_exit_naming_their_roadmap_item(module, extra, item):
    """``--devices 2`` exits naming its ROADMAP item; the flags ported since
    (``--use-flow`` on a sequence dataset, ``--visual``, ``--visual-from``)
    pass ``validate_args``, as they pass grl_tpu's."""
    if item is None:
        for m in (module, j_train if module is t_train else j_eval):
            m.validate_args(m.build_parser().parse_args(["--tiny"] + extra))
        return
    with pytest.raises(SystemExit, match=f"queue A, item {item}"):
        module.validate_args(module.build_parser().parse_args(["--tiny"] + extra))


def test_supported_flags_pass_and_the_device_defaults_to_cuda():
    for extra in (["--sample_method", "random"], ["--devices", "1"], ["--rerank", "1"]):
        t_train.validate_args(t_train.build_parser().parse_args(["--tiny"] + extra))
    assert t_train.build_parser().parse_args([]).device == "cuda"
    assert t_eval.build_parser().parse_args([]).device == "cuda"
    for parser in (t_train.build_parser(), t_eval.build_parser()):
        theirs = (j_train if parser.description.startswith("GRL training") else j_eval).build_parser()
        ours = {a.dest: a.default for a in parser._actions if a.dest not in ("help", "logs_dir")}
        want = {a.dest: a.default for a in theirs._actions if a.dest not in ("help", "logs_dir")}
        assert {k: v for k, v in ours.items() if k in want} == want
        assert set(ours) - set(want) <= {"device", "synthetic_ids"}


def test_evaluator_describes_in_eval_mode_after_training():
    """The CLI evaluates the modules it trains: features extracted after a
    train step (modules left in train mode) equal those of the same modules
    set to eval mode, and extraction leaves the BN statistics alone."""
    import argparse

    import torch

    from grl_tpu_torch.data import ClipDataset, ClipLoader, SyntheticVideoReID
    from grl_tpu_torch.engine import Evaluator, init_train_state, make_train_step

    cnn, sia, unc = t_train.build_models(argparse.Namespace(arch2="siamese", seed=0), tiny=True)
    state = init_train_state(cnn, sia, unc, 4, num_feat=cnn.num_feat, device="cpu")
    evaluator = Evaluator(cnn, sia, micro_batch=4, device="cpu")
    clips = torch.from_numpy(np.random.RandomState(0).randn(4, 2, 64, 32, 3).astype(np.float32))
    state, _ = make_train_step(device="cpu")(state, clips, [0, 0, 1, 1], 1e-3)
    assert cnn.training
    stats = {k: v.clone() for k, v in state.models.state_dict().items()}
    loader = ClipLoader(ClipDataset(SyntheticVideoReID(seed=0).gallery, 2, "dense", 64, 32), batch_size=1)
    after_step, _, _ = evaluator.extract_features(loader)
    assert not cnn.training and not sia.training
    for k, v in state.models.state_dict().items():
        assert torch.equal(v, stats[k]), k
    again, _, _ = evaluator.extract_features(loader)
    torch.testing.assert_close(after_step, again, rtol=0, atol=0)
