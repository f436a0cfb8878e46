"""The training step's share of the card's fp32 peak over the window: the
operations of every step (forward and backward, counted from shapes) over
the window's seconds, against 67 TFLOP/s (fp32 outside the tensor cores:
TF32 is off)."""

from reid_bench.peaks import PEAK_FP32_OPS


def read(run):
    if "step" not in run.ops:
        return None
    return 100.0 * run.ops["step"]["total"] * run.counters["steps"] / run.window_s / PEAK_FP32_OPS
