"""Sweep the backend's options on the full-size training step
(counterpart of ``tools/sweep_train_compiler_options.py``).

The same question as ``sweep_compiler_options`` over the training step
(model forward and backward, the five-term loss, SGD, the OIM lut
updates; ``engine.make_train_step``) at grl_tpu's batch: 16 clips = 8
pairs, seq_len 8, 256x128, 625 classes, full width, ``cli.train``'s
models (seed 0). Variants, each from the same initial weights and batch:

- ``default``: the bf16 step as the port runs it (``--bf16``);
- ``cudnn_benchmark``, ``channels_last``, ``channels_last_benchmark``:
  cuDNN's autotuning, the modules' 4-d weights in NHWC, both (the two
  that autotune each in a process of its own, so that the search starts
  from an empty plan cache);
- ``default2``: ``default`` again, for the noise;
- ``fp32``: the fp32 step (the CLIs' default precision, TF32 off);
- ``fp32_deterministic``: the fp32 step in a child process started with
  ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``, as
  ``learning_equivalence --deterministic`` trains; the ops that warned for
  want of a deterministic kernel are listed.

Each prints the seconds of its first step (cuDNN's set-up and autotuning
land there), its loss, and three CUDA-event ms per step over 10
steps after 2 (the host clock on the CPU). Every bf16 variant's
first-step loss is held to ``default``'s: within 1e-2 where cuDNN's
heuristics pick the algorithms, within 2^-6 of it (bf16's tolerance
between two kernels) where the search picks others. No default of the
port changes: the flag and the layout are put back after each variant.

    python3 -m grl_tpu_torch.tools.sweep_train_compiler_options [--device cuda]
"""

from __future__ import annotations

import argparse
import copy
import json
import time
import warnings

import numpy as np
import torch

from .. import resolve_device, set_precision
from ..engine import init_train_state, make_train_step
from ..utils.profiling import card_line, sync, window_ms
from .learning_equivalence import NONDETERMINISTIC_RE
from .profile_train_step import build_models
from .sweep_compiler_options import FRESH, in_child, variant

VARIANTS = ("default", "cudnn_benchmark", "channels_last", "channels_last_benchmark", "default2", "fp32",
            "fp32_deterministic")
# each in a process of its own: the benchmark variants for an empty cuDNN
# plan cache (``sweep_compiler_options.FRESH``), the deterministic one for
# its cuBLAS workspace setting, read when CUDA starts
FRESH = (*FRESH, "fp32_deterministic")
NUM_CLASSES = 625
TOL = 1e-2  # first-step losses of bf16 steps from the same state under cuDNN's heuristics, another layout
# the autotuned steps run other bf16 algorithms: relative to default's loss,
# bf16's tolerance between two kernels' results (chip_smoke.py's DP_BN_TOL)
TUNED_TOL = 2.0**-6
BATCH, SEQ_LEN, FRAME = 16, 8, (256, 128)  # grl_tpu's batch: 8 pairs of 8 x 256x128 clips
STEPS, WINDOWS, WARM = 10, 3, 2  # steps per timed window, timed windows, steps of the warm window


def run_variant(name, modules, device, batch, seq_len, frame, steps, windows, warm):
    """One variant in this process from copies of ``modules``: its first
    step's seconds and loss, then ``windows`` ms per step; under
    deterministic algorithms also the ops that warned for want of a
    deterministic kernel."""
    rng = np.random.RandomState(0)
    clips = torch.from_numpy(rng.randn(batch, seq_len, *frame, 3).astype(np.float32)).to(device)
    pids = np.repeat(np.arange(batch // 2) % NUM_CLASSES, 2).astype(np.int64)
    mods = [copy.deepcopy(m) for m in modules]
    with warnings.catch_warnings(record=True) as caught, variant(name, mods):
        warnings.simplefilter("always")
        state = init_train_state(*mods, NUM_CLASSES, num_feat=mods[0].num_feat, device=device)
        step = make_train_step(device=device)
        sync(device)
        t0 = time.perf_counter()
        loss = float(step(state, clips, pids, 1e-3)[1]["loss"])  # a host read ends the first step
        first_s = time.perf_counter() - t0
        window_ms(lambda: step(state, clips, pids, 1e-3), warm, device)
        ms = [window_ms(lambda: step(state, clips, pids, 1e-3), steps, device) / steps for _ in range(windows)]
    row = {"first_step_s": first_s, "loss": loss, "ms_per_step": ms}
    if torch.are_deterministic_algorithms_enabled():
        row["nondeterministic_ops"] = sorted({m for w in caught for m in NONDETERMINISTIC_RE.findall(str(w.message))})
    return row


def dtype_of(name):
    return "fp32" if name.startswith("fp32") else "bf16"


def _child(device, name, sizes):
    """``sweep``'s fresh variants: ``name`` alone in this process, under
    the CLIs' policy (``fp32_deterministic`` under deterministic
    algorithms, as ``learning_equivalence --deterministic`` trains); its
    row on the last line."""
    set_precision()
    if name == "fp32_deterministic":
        torch.use_deterministic_algorithms(True, warn_only=True)
    device = resolve_device(device)
    modules = build_models("cpu", False, dtype_of(name))
    print(json.dumps(run_variant(name, modules, device, sizes["batch"], sizes["seq_len"], sizes["frame"],
                                 sizes["steps"], sizes["windows"], sizes["warm"])))


def sweep(device="cuda", batch=BATCH, seq_len=SEQ_LEN, frame=FRAME, steps=STEPS, windows=WINDOWS, warm=WARM,
          variants=VARIANTS, report=print):
    """``{variant: {"first_step_s", "loss", "ms_per_step": [...]}}`` (the
    deterministic row also ``nondeterministic_ops``); ``report`` gets one
    line per variant. The ``FRESH`` variants run each in a child process,
    the rest in this one."""
    device = resolve_device(device)
    sizes = {"batch": batch, "seq_len": seq_len, "frame": list(frame), "steps": steps, "windows": windows,
             "warm": warm}
    modules = {}  # by dtype, built on the host once and copied for each variant
    out = {}
    for name in variants:
        if name in FRESH:
            env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"} if name == "fp32_deterministic" else None
            row = in_child("sweep_train_compiler_options", str(device), name, sizes, env=env)
        else:
            dtype = dtype_of(name)
            if dtype not in modules:
                modules[dtype] = build_models("cpu", False, dtype)
            row = run_variant(name, modules[dtype], device, batch, seq_len, frame, steps, windows, warm)
        out[name] = row
        ops = f", nondeterministic ops {row['nondeterministic_ops']}" if "nondeterministic_ops" in row else ""
        report(f"{name}: {', '.join(f'{t:.1f}' for t in row['ms_per_step'])} ms/step "
               f"(first step {row['first_step_s']:.2f}s{', own process' if name in FRESH else ''}, "
               f"loss {row['loss']:.6f}{ops})")
    ref = out.get("default")
    for name, row in out.items():
        if ref is None or dtype_of(name) != "bf16":
            continue
        tol = TUNED_TOL * abs(ref["loss"]) if name.endswith("benchmark") else TOL
        if not abs(row["loss"] - ref["loss"]) <= tol:
            raise RuntimeError(f"{name}'s first-step loss {row['loss']} is not within {tol} of default's "
                               f"{ref['loss']}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", type=str, default="cuda", help="torch device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    set_precision()
    print(f"card: {card_line(device)}", flush=True)
    res = sweep(device, BATCH, SEQ_LEN, FRAME, STEPS, WINDOWS, WARM, report=lambda line: print(line, flush=True))
    print(json.dumps({"batch": BATCH, "seq_len": SEQ_LEN, "frame": list(FRAME), "num_classes": NUM_CLASSES,
                      "variants": res}))
    return res


if __name__ == "__main__":
    main()
