"""The min-plus kernel's share of its roofline over the traced serving
window: the least time of the min-sums the answered requests' live
queries need (operations at the fp32 peak or bytes at 3.35 TB/s,
whichever bounds each; ``counts.min_sum_work``) over the kernel's time in
the daemon's device trace."""

from reid_bench.counts import min_sum_work
from reid_bench.peaks import PEAK_BYTES, PEAK_FP32_OPS


def read(run):
    if "live_queries" not in run.counters or run.device_trace is None:
        return None
    seconds = run.device_trace.seconds_where(lambda name: "minplus" in name.lower())
    if seconds <= 0:
        return None
    n_g = run.counters["gallery"]
    least = 0.0
    for q in run.counters["live_queries"]:
        ops, nbytes = min_sum_work(q, q + n_g)
        least += max(ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES)
    return 100.0 * least / seconds
