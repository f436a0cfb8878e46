"""The port's learning check (``grl_tpu_torch/tools/learning_equivalence.py``)
against grl_tpu's tool (``tools/learning_equivalence.py``).

Its helpers against the JAX tool's (the eval cadence, the eval-block
parser on the JAX test's texts and on the port evaluator's own print), the
summary over a copy of the recorded runs (``docs/leq_r5``: the reference
and grl_tpu envelopes of ``summary.json`` exactly), the verdicts on fake
runs as ``tests/test_learning_equivalence.py`` makes them, the committed
card runs' logs read back into their records, one tiny free-running run of
the port's CLI on the CPU (2 ids, 1 epoch, ``--tiny``, 64x32 frames) read
back in the recorded shape, and two ``--deterministic`` ones that repeat.
"""

import contextlib
import io
import json
import os.path as osp
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, osp.join(osp.dirname(__file__), ".."))

from grl_tpu_torch.engine.evaluator import print_protocol  # noqa: E402
from grl_tpu_torch.tools import learning_equivalence as tleq  # noqa: E402
from tools import learning_equivalence as jleq  # noqa: E402

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
RECORDED = osp.join(REPO, "docs", "leq_r5")
CARD_RUNS = osp.join(REPO, "docs", "leq_torch")
JAX_TEST_TEXT = ("Computing distance matrix\n"
                 "Mean AP: 93.8%\n"
                 "Rank-1  : 100.0%\n"
                 "Rank-5  : 100.0%\n"
                 "Rank-10 : 100.0%\n")


def test_eval_epochs_match_grl_tpu_tool():
    for epochs in range(1, 41):
        assert tleq.eval_epochs(epochs) == jleq.eval_epochs(epochs)


def test_parse_eval_block_matches_grl_tpu_tool():
    """The JAX test's texts, repeated blocks, no block, and the block the
    port's evaluator prints."""
    texts = [JAX_TEST_TEXT, JAX_TEST_TEXT + "Mean AP: 50.0%\nRank-1  : 62.5%\n", "no eval here"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        print_protocol(np.array([0.625, 0.75, 0.8125, 0.875, 0.9375] + [1.0] * 20), 0.7312)
    texts.append(buf.getvalue())
    for text in texts:
        assert tleq.parse_eval_block(text) == jleq.parse_eval_block(text)
    assert tleq.parse_eval_block(texts[-1]) == {"mAP": 73.1, "rank1": 62.5, "rank5": 93.8, "rank10": 100.0,
                                                "rank20": 100.0}


@pytest.mark.parametrize("name", [f"torch_seed{s}{p}" for p in ("", "_bf16") for s in range(4)])
def test_parse_log_reproduces_the_card_runs(name):
    """``run_torch``'s reading of a committed card run's tee log gives the
    run's recorded epoch losses and evaluations, and each of its eval
    blocks is what the JAX tool's parser reads from the same text."""
    rec = json.load(open(osp.join(CARD_RUNS, f"{name}.json")))
    text = open(osp.join(CARD_RUNS, f"{name}.log_train0.txt")).read()
    epoch_losses, evals = tleq.parse_log(text, rec["schedule"]["epochs"])
    assert (epoch_losses, evals) == (rec["epoch_losses"], rec["evals"])
    assert [e for e, _ in epoch_losses] == list(range(rec["schedule"]["epochs"]))
    blocks = ["Mean AP" + b for b in text.split("Mean AP")[1:]]
    assert len(blocks) == len(evals) == len(tleq.eval_epochs(rec["schedule"]["epochs"]))
    for block, ev in zip(blocks, evals):
        assert jleq.parse_eval_block(block) == {k: v for k, v in ev.items() if k not in ("epoch", "top1")}


def test_summarize_reproduces_the_recorded_envelopes(tmp_path):
    """Over a copy of ``docs/leq_r5`` (its ``grl_seed0_highest_precision.json``
    included, which the recorded summary does not count), with no run of
    the port: the ``ref`` and ``grl`` envelopes of ``summary.json``."""
    recorded = tmp_path / "leq_r5"
    shutil.copytree(RECORDED, recorded)
    out = tmp_path / "out"
    s = tleq.main(["--out", str(out), "--recorded", str(recorded), "--summarize-only"])
    want = json.load(open(osp.join(RECORDED, "summary.json")))
    assert s["ref"] == want["ref"]
    assert s["grl"] == want["grl"]
    assert "torch" not in s and "verdict" not in s
    assert (out / "summary.md").read_text().count("| grl/tpu |") == 4


def _fake_run(out, side, seed, mAP, rank1, steps=4, bf16=False):
    rec = {
        "side": side, "seed": seed, "bf16": bf16,
        "loss_steps": [[i, 20.0 - i] for i in range(steps)],
        "evals": [{"epoch": 7, "mAP": mAP, "rank1": rank1, "top1": rank1 / 100.0}],
        "wall_s": 1.0,
    }
    with open(osp.join(out, f"{side}_seed{seed}{'_bf16' if bf16 else ''}.json"), "w") as f:
        json.dump(rec, f)


def test_summarize_verdict_within_and_divergent(tmp_path):
    """The JAX test's runs, the port's in place of grl_tpu's: within, then
    divergent; a bf16 run gets its own verdict; grl_tpu's median and the gap
    to it stand beside."""
    recorded, out = tmp_path / "recorded", tmp_path / "out"
    recorded.mkdir()
    out.mkdir()
    args = tleq.build_parser().parse_args(["--out", str(out), "--recorded", str(recorded)])
    _fake_run(str(recorded), "ref", 0, 90.0, 95.0)
    _fake_run(str(recorded), "ref", 1, 84.0, 88.0)
    _fake_run(str(recorded), "grl", 0, 80.0, 85.0)
    _fake_run(str(out), "torch", 0, 88.0, 92.0)
    s = tleq.summarize(args)
    # |87-88| <= max(ref span 6.0, 5.0) -> within
    assert s["verdict"] == "WITHIN seed noise"
    assert s["ref"]["final_mAP"]["median"] == 87.0
    assert s["torch"]["seeds"] == [0]
    assert s["torch_minus_grl_median_mAP"] == 8.0
    assert "verdict_bf16" not in s
    assert "grl_tpu's median 80.0%" in (out / "summary.md").read_text()

    _fake_run(str(out), "torch", 1, 60.0, 55.0)
    _fake_run(str(out), "torch", 0, 86.0, 90.0, bf16=True)
    s = tleq.summarize(args)
    # the port's median 74 vs ref 87: past the max(span, 5) envelope -> divergent
    assert s["verdict"] == "DIVERGENT"
    assert s["verdict_bf16"] == "WITHIN seed noise"
    assert s["torch_bf16"]["seeds"] == [0] and s["torch"]["seeds"] == [0, 1]


def test_run_torch_tiny_on_the_cpu(tmp_path):
    """One free-running seed through ``python -m grl_tpu_torch.cli.train -d
    mars`` on a 2-id tree of 64x32 JPEGs (``--tiny``, ``--device cpu``): the
    recorded keys, one loss per step of the loader's epoch, the evaluations
    at the tool's cadence, and the summary beside the recorded runs."""
    from grl_tpu_torch.data import get_data

    # tracklets stay 2: with 1 a (pid, camera) and 2 query cameras, every
    # test tracklet is a query and the gallery is empty
    args = tleq.build_parser().parse_args(["--out", str(tmp_path), "--device", "cpu", "--train-ids", "2",
                                           "--test-ids", "2", "--epochs", "1", "--batch", "4", "--seq-len", "2",
                                           "--seeds", "0"])
    tree = tleq.build_tree(args, frame=(64, 32))
    run = tleq.run_torch(args, tree, 0, extra=["--tiny"])
    assert sorted(run) == sorted(["side", "seed", "platform", "bf16", "card", "loss_steps", "epoch_losses", "evals",
                                  "wall_s", "schedule"])
    assert json.load(open(tmp_path / "torch_seed0.json")) == json.loads(json.dumps(run))
    assert (run["side"], run["seed"], run["platform"], run["bf16"], run["card"]) == ("torch", 0, "cpu", False, None)
    steps = len(get_data("mars", tree, args.batch, args.seq_len, args.seq_srd, 0)[2]) * args.epochs
    assert steps > 0 and [s for s, _ in run["loss_steps"]] == list(range(steps))
    assert all(np.isfinite(v) for _, v in run["loss_steps"])
    assert [e for e, _ in run["epoch_losses"]] == list(range(args.epochs))
    assert [e["epoch"] for e in run["evals"]] == tleq.eval_epochs(args.epochs) == [0]
    assert {"mAP", "rank1", "top1"} <= set(run["evals"][0])
    assert run["schedule"]["out"] is None and run["schedule"]["epochs"] == 1
    s = tleq.summarize(args)
    assert s["torch"]["seeds"] == [0] and s["verdict"] in ("WITHIN seed noise", "DIVERGENT")
    assert s["ref"] == json.load(open(osp.join(RECORDED, "summary.json")))["ref"]


def test_run_torch_deterministic_repeats_on_the_cpu(tmp_path):
    """``--deterministic``: the CLI under torch's deterministic kernels, twice
    on the same seed, gives the same losses and evaluations, and the record
    lists the ops that warned for want of a deterministic kernel."""
    runs = []
    for rep in range(2):
        out = tmp_path / f"rep{rep}"
        args = tleq.build_parser().parse_args(["--out", str(out), "--device", "cpu", "--train-ids", "2",
                                               "--test-ids", "2", "--epochs", "1", "--batch", "4", "--seq-len",
                                               "2", "--seeds", "0", "--deterministic"])
        runs.append(tleq.run_torch(args, tleq.build_tree(args, frame=(64, 32)), 0, extra=["--tiny"]))
    a, b = runs
    assert a["schedule"]["deterministic"] is True and isinstance(a["nondeterministic_ops"], list)
    assert a["loss_steps"] and a["loss_steps"] == b["loss_steps"]
    assert a["evals"] and a["evals"] == b["evals"]


def test_parser_keeps_grl_tpu_s_schedule_flags():
    """The schedule's flags and defaults are the JAX tool's; ``--device``
    defaults to the card; the reference side's flags and ``--smoke`` (a
    full-width plumbing run, which the tests make at tiny width) are gone,
    and ``--bf16`` stands for ``--grl-bf16``."""
    ours = vars(tleq.build_parser().parse_args(["--out", "x"]))
    theirs = vars(jleq.build_parser().parse_args(["--out", "x"]))
    shared = set(theirs) - {"side", "grl_tpu", "grl_bf16", "grl_worker", "smoke"}
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
    assert ours["device"] == "cuda" and ours["bf16"] is False and ours["deterministic"] is False
    assert ours["recorded"] == RECORDED
    for flag in (["--side", "ref"], ["--grl-tpu"], ["--grl-bf16"], ["--smoke"]):
        with pytest.raises(SystemExit):
            tleq.build_parser().parse_args(["--out", "x", *flag])
