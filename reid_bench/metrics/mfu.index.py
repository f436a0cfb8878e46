"""The descriptor's share of the card's bf16 peak over the window: the
operations of every clip described (counted from shapes) over the
window's seconds, against 989 TFLOP/s."""

from reid_bench.peaks import PEAK_BF16_OPS


def read(run):
    if "clip" not in run.ops:
        return None
    return 100.0 * run.ops["clip"]["total"] * run.counters["clips"] / run.window_s / PEAK_BF16_OPS
