"""The convolutions' and matrix products' share of their roofline in the
traced index window: the product operations of every clip described
(counted from shapes) over the seconds of the convolution and GEMM kernels
in the device trace, against the bf16 peak. At these shapes (arithmetic
intensity in the hundreds) the operations bound them, not the bytes."""

from reid_bench.peaks import PEAK_BF16_OPS, is_product_kernel


def read(run):
    if "clip" not in run.ops or run.device_trace is None:
        return None
    seconds = run.device_trace.seconds_where(is_product_kernel)
    if seconds <= 0:
        return None
    return 100.0 * run.ops["clip"]["total"] * run.counters["clips"] / seconds / PEAK_BF16_OPS
