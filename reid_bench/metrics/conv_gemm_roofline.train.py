"""The convolutions' and matrix products' share of their roofline in the
traced training window: the product operations of every step, forward and
backward (counted from shapes), over the seconds of the convolution and
GEMM kernels in the device trace, against the fp32 peak (TF32 is off)."""

from reid_bench.peaks import PEAK_FP32_OPS, is_product_kernel


def read(run):
    if "step" not in run.ops or run.device_trace is None:
        return None
    seconds = run.device_trace.seconds_where(is_product_kernel)
    if seconds <= 0:
        return None
    return 100.0 * run.ops["step"]["total"] * run.counters["steps"] / seconds / PEAK_FP32_OPS
