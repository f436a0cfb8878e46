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
against. grl_tpu's ``enable_compilation_cache`` and
``descriptor_compiler_options`` tune XLA and have no counterpart here.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet: dense bf16 on the tensor
# cores, fp32 outside them, and device memory bandwidth
PEAK_BF16_OPS = 989e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


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
