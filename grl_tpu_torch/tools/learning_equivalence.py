"""Free-running learning check of the port against the recorded runs
(counterpart of ``tools/learning_equivalence.py``, its training side).

Every training test of the port is per-step: one or two steps held leaf by
leaf against grl_tpu. This tool trains the port free-running to an outcome
and compares the outcome with the runs that the repository records in
``docs/leq_r5``: the literal reference on torch-CPU (``ref_seed*.json``)
and grl_tpu on its TPU (``grl_seed*.json``), all on the same fake-MARS tree
through the same miniature schedule (lr decays inside the run). Each seed
runs the port's real CLI, ``python -m grl_tpu_torch.cli.train -d mars``, in
a subprocess, with the JAX tool's flags and ``--device`` (default
``cuda``); ``--bf16`` trains in bfloat16, and ``--deterministic`` with
torch's deterministic kernels (whether one seed repeats). The tree is the port's
``make_fake_mars`` with the JAX tool's arguments, which writes grl_tpu's
tree byte for byte. A seed varies the initial weights, the sampling and the
augmentation; the data stays fixed.

The outcome is read from the CLI's own outputs, as the JAX tool reads
grl_tpu's: the per-step losses from ``train_log/scalars.jsonl``, the epoch
losses and the periodic evaluations (mAP and rank-k blocks at grl_tpu's
cadence) from ``log_train0.txt``. Each seed writes
``OUT/torch_seed{N}.json`` (``torch_seed{N}_bf16.json`` with ``--bf16``)
in the recorded runs' shape. The summary puts the port's seeds beside the
recorded ones and gives the JAX tool's verdict: the port's median final mAP
within max(the reference's seed span, 5) points of the reference's median,
with the gap to grl_tpu's median beside it (``OUT/summary.json``,
``OUT/summary.md``).

The reference side of the JAX tool is not here: it loads the reference's
sources from outside the repository, which the recorded runs stand in for.

If the verdict is DIVERGENT, the JAX tool's first suspect is the
reference's Siamese heads, which train with eval-mode BatchNorm after the
first periodic evaluation (its ``attevaluator.py:62-63``); grl_tpu and the
port train every module in training mode throughout.

    python3 -m grl_tpu_torch.tools.learning_equivalence --out build/leq --seeds 0 1 2 3 --epochs 6 --lr-step 2
    python3 -m grl_tpu_torch.tools.learning_equivalence --out build/leq --seeds 0 1 2 3 --epochs 6 --lr-step 2 --bf16
    python3 -m grl_tpu_torch.tools.learning_equivalence --out build/leq --summarize-only
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import re
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
RECORDED = osp.join(REPO, "docs", "leq_r5")
EVAL_RE = re.compile(r"Mean AP: *([\d.]+)%")
RANK_RE = re.compile(r"Rank-(\d+) *: *([\d.]+)%")
EPOCH_LOSS_RE = re.compile(r"^epoch (\d+): loss ([\d.]+) ", re.M)
RUN_RE = re.compile(r"^(ref|grl|torch)_seed(\d+)(_bf16)?\.json$")
# the training CLI with torch's deterministic kernels; an op that has none
# warns (NONDETERMINISTIC_RE reads its name) and runs as it is
DETERMINISTIC_CLI = ("import torch; torch.use_deterministic_algorithms(True, warn_only=True); "
                     "from grl_tpu_torch.cli.train import cli; cli()")
NONDETERMINISTIC_RE = re.compile(r"(\S+) does not have a deterministic implementation")


def eval_epochs(epochs):
    """The literal periodic-eval cadence (mars_train.py:135)."""
    return [e for e in range(epochs)
            if (e + 1) % 5 == 0 or (e + 1) == epochs
            or ((e + 1) > 30 and (e + 1) % 3 == 0)]


def build_tree(args, frame=(256, 128)):
    """One shared fake-MARS tree for every seed (data fixed; seeds vary
    init + sampling/augmentation RNG), at the JAX tool's arguments. 256x128
    frames on disk, so the loader's resize to 256x128 is a no-op; ``frame``
    writes smaller ones (tests)."""
    from .make_fake_mars import make_fake_mars

    tree = osp.join(args.out, "tree")
    if not osp.exists(osp.join(tree, "info", "query_IDX.mat")):
        make_fake_mars(
            tree,
            train_ids=args.train_ids,
            test_ids=args.test_ids,
            cams=2,
            tracklets_per_id_cam=args.tracklets,
            test_tracklets_per_id_cam=args.tracklets,
            frames_range=(12, 20),
            height=frame[0],
            width=frame[1],
            seed=args.data_seed,
            junk_tracklets=1,
            query_cams=2,
        )
        print(f"[leq] wrote tree {tree}")
    return tree


def parse_eval_block(text):
    """mAP + rank-k out of the literal evaluate_seq prints
    (attevaluator.py:24-28; the port's evaluator prints the same format)."""
    maps = [float(m) for m in EVAL_RE.findall(text)]
    ranks = {}
    for k, v in RANK_RE.findall(text):
        ranks.setdefault(int(k), []).append(float(v))
    if not maps:
        return None
    return {
        "mAP": maps[-1],
        **{f"rank{k}": v[-1] for k, v in ranks.items()},
    }


def parse_log(text, epochs):
    """The epoch losses and the periodic evaluations out of the CLI's tee
    log: one eval block from each "Mean AP" line to the next, at the
    literal cadence (``eval_epochs``)."""
    epoch_losses = [[int(e), float(l)] for e, l in EPOCH_LOSS_RE.findall(text)]
    blocks = [parse_eval_block("Mean AP" + b) for b in text.split("Mean AP")[1:]]
    evals = [block | {"epoch": ep, "top1": block.get("rank1", 0.0) / 100.0}
             for ep, block in zip(eval_epochs(epochs), blocks)]
    return epoch_losses, evals


def _shown(path):
    """``path`` relative to the repository when it lies inside it (the
    recorded runs are named as the repository names them), else as given."""
    full = osp.abspath(path)
    return osp.relpath(full, REPO) if full.startswith(REPO + os.sep) else path


def run_name(seed, bf16):
    return f"torch_seed{seed}{'_bf16' if bf16 else ''}"


def card():
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_torch(args, tree, seed, extra=()):
    """Train + evaluate the port through its real CLI in a subprocess;
    ``extra`` CLI arguments go last. Writes and returns the run's record."""
    t0 = time.time()
    name = run_name(seed, args.bf16)
    logdir = osp.join(args.out, name)
    shutil.rmtree(logdir, ignore_errors=True)  # the CLI tees into the first free log_train{N}.txt
    cmd = [
        sys.executable, "-m", "grl_tpu_torch.cli.train",
        "-d", "mars", "--data-dir", tree, "-b", str(args.batch),
        "--seq_len", str(args.seq_len), "--seq_srd", str(args.seq_srd),
        "--epochs", str(args.epochs), "--lr_step", str(args.lr_step),
        "--lr", str(args.lr), "--seed", str(seed), "--logs-dir", logdir,
        "-j", "2", "--device", args.device,
    ]
    if args.bf16:
        cmd.append("--bf16")
    cmd += list(extra)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    if args.deterministic:
        cmd[1:3] = ["-c", DETERMINISTIC_CLI]
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    proc = subprocess.run(cmd, env=env, stderr=subprocess.PIPE if args.deterministic else None, text=True)
    if proc.stderr:
        sys.stderr.write(proc.stderr)
    proc.check_returncode()

    with open(osp.join(logdir, "log_train0.txt")) as f:
        epoch_losses, evals = parse_log(f.read(), args.epochs)

    loss_steps = []
    scalars = osp.join(logdir, "train_log", "scalars.jsonl")
    if osp.exists(scalars):
        with open(scalars) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"] == "train/total_loss_step":
                    loss_steps.append([rec["step"], rec["value"]])

    out = {
        "side": "torch",
        "seed": seed,
        "platform": args.device,
        "bf16": bool(args.bf16),
        "card": card() if args.device.startswith("cuda") else None,
        "loss_steps": loss_steps,
        "epoch_losses": epoch_losses,
        "evals": evals,
        "wall_s": round(time.time() - t0, 1),
        "schedule": vars(args) | {"out": None, "recorded": _shown(args.recorded)},
    }
    if args.deterministic:
        out["nondeterministic_ops"] = sorted(set(NONDETERMINISTIC_RE.findall(proc.stderr)))
    path = osp.join(args.out, f"{name}.json")
    with open(path, "w") as f:
        json.dump(out, f)
    print(f"[leq] wrote {path} ({out['wall_s']}s)")
    return out


def _env(vals):
    vals = sorted(vals)
    mid = vals[len(vals) // 2] if len(vals) % 2 else 0.5 * (
        vals[len(vals) // 2 - 1] + vals[len(vals) // 2])
    return {"min": vals[0], "median": round(mid, 3), "max": vals[-1], "n": len(vals)}


def _read_runs(directory, sides):
    """The runs ``RUN_RE`` names in ``directory`` whose side is one of
    ``sides``, by group: ``ref``, ``grl``, ``torch`` and ``torch_bf16``."""
    runs = {}
    if not osp.isdir(directory):
        return runs
    for name in sorted(os.listdir(directory)):
        m = RUN_RE.match(name)
        if m and m.group(1) in sides:
            with open(osp.join(directory, name)) as f:
                runs.setdefault(m.group(1) + (m.group(3) or ""), []).append(json.load(f))
    return runs


def _tag(group, r):
    if group == "grl":
        return f"grl/{r.get('platform', '?')}{'/bf16' if r.get('bf16') else ''}"
    if group.startswith("torch"):
        return f"torch/{r.get('platform', '?')}{'/bf16' if r.get('bf16') else ''}"
    return group


def summarize(args):
    """The port's runs in ``args.out`` beside the recorded runs in
    ``args.recorded``: the table, the envelopes and the verdicts (one per
    precision of the port's runs). Writes ``summary.json`` and
    ``summary.md`` under ``args.out``; returns the summary."""
    runs = _read_runs(args.recorded, ("ref", "grl")) | _read_runs(args.out, ("torch",))
    recorded = _shown(args.recorded)
    summary = {"config": {k: v for k, v in vars(args).items() if k != "summarize_only"} | {"recorded": recorded}}
    lines = ["# Learning equivalence: the port vs the recorded reference and grl_tpu runs", ""]
    lines.append(f"Shared fake-MARS tree: {args.train_ids} train ids x 2 cams x "
                 f"{args.tracklets} tracklets, {args.test_ids} test ids; batch "
                 f"{args.batch}, seq_len {args.seq_len}, {args.epochs} epochs, "
                 f"lr {args.lr} x0.1 every {args.lr_step} (decays inside the run); "
                 f"free-running, every side from random init, seeds vary "
                 f"init+sampling+augmentation. Recorded runs: {recorded}.")
    lines.append("")
    lines.append("| side | seed | final mAP % | final rank-1 % | first-step loss | final-epoch loss | wall s |")
    lines.append("|---|---|---|---|---|---|---|")
    groups = [g for g in ("ref", "grl", "torch", "torch_bf16") if runs.get(g)]
    for group in groups:
        for r in runs[group]:
            fin = r["evals"][-1] if r["evals"] else {}
            ls = r["loss_steps"]
            first = ls[0][1] if ls else float("nan")
            k = max(1, len(ls) // r.get("schedule", {}).get("epochs", args.epochs))
            last_ep = [v for _, v in ls[-k:]] if ls else [float("nan")]
            lines.append(
                f"| {_tag(group, r)} | {r['seed']} | {fin.get('mAP', float('nan')):.1f} | "
                f"{fin.get('rank1', float('nan')):.1f} | {first:.1f} | "
                f"{float(np.mean(last_ep)):.2f} | {r['wall_s']:.0f} |")
    for group in groups:
        summary[group] = {
            "final_mAP": _env([r["evals"][-1]["mAP"] for r in runs[group] if r["evals"]]),
            "final_rank1": _env([r["evals"][-1].get("rank1", 0.0) for r in runs[group] if r["evals"]]),
            "first_step_loss": _env([r["loss_steps"][0][1] for r in runs[group] if r["loss_steps"]]),
            "final_step_loss": _env([r["loss_steps"][-1][1] for r in runs[group] if r["loss_steps"]]),
            "seeds": [r["seed"] for r in runs[group]],
        }
    lines.append("")
    if "ref" in summary:
        rm = summary["ref"]["final_mAP"]["median"]
        ref_span = summary["ref"]["final_mAP"]["max"] - summary["ref"]["final_mAP"]["min"]
        for group in ("torch", "torch_bf16"):
            if group not in summary:
                continue
            tm = summary[group]["final_mAP"]["median"]
            verdict = "WITHIN seed noise" if abs(tm - rm) <= max(ref_span, 5.0) else "DIVERGENT"
            key = "verdict" if group == "torch" else "verdict_bf16"
            summary[key] = verdict
            line = (f"Median final mAP: reference {rm:.1f}% vs the port{' (bf16)' if group != 'torch' else ''} "
                    f"{tm:.1f}% (reference seed span {ref_span:.1f} pts) -> **{verdict}**")
            if "grl" in summary:
                gm = summary["grl"]["final_mAP"]["median"]
                summary[f"{group}_minus_grl_median_mAP"] = round(tm - gm, 3)
                line += f"; grl_tpu's median {gm:.1f}% (the port {tm - gm:+.1f} pts)"
            lines.append(line + ".")
    text = "\n".join(lines) + "\n"
    with open(osp.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    with open(osp.join(args.out, "summary.md"), "w") as f:
        f.write(text)
    print(text)
    return summary


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--recorded", default=RECORDED,
                    help="directory of the recorded ref_seed*/grl_seed* runs (default docs/leq_r5)")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--lr-step", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=4)
    ap.add_argument("--seq-srd", type=int, default=4)
    ap.add_argument("--train-ids", type=int, default=8)
    ap.add_argument("--test-ids", type=int, default=8)
    ap.add_argument("--tracklets", type=int, default=2,
                    help="tracklets per (id, cam)")
    ap.add_argument("--data-seed", type=int, default=100)
    ap.add_argument("--bf16", action="store_true", help="train the port in bfloat16")
    ap.add_argument("--deterministic", action="store_true",
                    help="train with torch.use_deterministic_algorithms (cuBLAS's fixed workspace); the record "
                         "lists the ops that warned for want of a deterministic kernel")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the training runs (default cuda; cpu runs on the host)")
    ap.add_argument("--summarize-only", action="store_true")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.summarize_only:
        return summarize(args)
    tree = build_tree(args)
    for seed in args.seeds:
        run_torch(args, tree, seed)
    return summarize(args)


if __name__ == "__main__":
    main()
