"""The re-ranked requests' share of the card's peaks while it worked on
them: the least seconds each answered request's work needs at the
data-sheet peaks (``counts.rerank_request_least_s``: distance products in
fp32, the 0/1 products in bf16, the min-sum), summed over the traced
window, over the seconds in which the daemon's device trace shows an
operation running. (Over the window's seconds instead, the share would
follow the offered rate of an open-loop cell, not the program's speed.)"""

from reid_bench.counts import rerank_request_least_s
from reid_bench.peaks import PEAK_BF16_OPS, PEAK_BYTES, PEAK_FP32_OPS


def read(run):
    if "live_queries" not in run.counters or run.device_trace is None or run.device_trace.busy_s() <= 0:
        return None
    least = sum(rerank_request_least_s(q, run.counters["gallery"], run.counters["dim"], PEAK_FP32_OPS,
                                       PEAK_BF16_OPS, PEAK_BYTES) for q in run.counters["live_queries"])
    return 100.0 * least / run.device_trace.busy_s()
