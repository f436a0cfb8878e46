"""Tracing and throughput hooks (counterpart of
``grl_tpu/utils/profiling.py:22-62``).

- ``trace(logdir)``: a context manager over ``torch.profiler`` (CPU
  activity, and CUDA where a card is present) that writes a Chrome trace
  of whatever runs inside into ``logdir``;
- ``ThroughputMeter``: items/s and steps/s over ``update`` calls. Given a
  CUDA device it waits for the device (``torch.cuda.synchronize``) before
  each reading of the clock, so the time counts the device's work and not
  only its enqueueing.

It also holds the card's peaks, which ``chip_smoke.py`` and
``tools/profile_train_step.py`` compute their bounds and roofline shares
against, and the tools' helpers: ``card_line`` (the card's name and power
limit), ``sync`` and ``window_ms`` (one timed window of calls). grl_tpu's ``enable_compilation_cache`` and
``descriptor_compiler_options`` tune XLA and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import torch

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet: dense bf16 and dense int8
# on the tensor cores (the sheet's 1,979 TFLOPS and 3,958 TOPS are with
# sparsity, twice the dense rates), fp32 outside them, and device memory
# bandwidth
PEAK_BF16_OPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


def card_line(device):
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them; a CPU device
    names itself instead."""
    if torch.device(device).type != "cuda":
        return f"{device}: no card"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window_ms(fn, iters, device):
    """Milliseconds of one window of ``iters`` calls of ``fn()``: between
    two CUDA events on a card (the work queued before it finished first),
    on the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        sync(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def trace(logdir):
    """Profile the block; on exit write ``logdir/trace.json`` (Chrome
    format). Yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class ThroughputMeter:
    """Aggregate items/s over ``update()`` calls; ``device`` (a CUDA device)
    makes each clock reading wait for the device first."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def reset(self):
        self.items = 0
        self.steps = 0
        self.elapsed = 0.0
        self._t0 = None

    def _now(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def start(self):
        self._t0 = self._now()

    def update(self, n_items):
        if self._t0 is None:
            raise RuntimeError("call start() before update()")
        now = self._now()
        self.elapsed += now - self._t0
        self.items += n_items
        self.steps += 1
        self._t0 = now

    @property
    def items_per_sec(self):
        return self.items / self.elapsed if self.elapsed > 0 else 0.0

    @property
    def steps_per_sec(self):
        return self.steps / self.elapsed if self.elapsed > 0 else 0.0
