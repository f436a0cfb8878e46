"""The daemon's wait for its index lock per re-ranked request: the median
length of the ``serve.lock_wait`` spans that the traced responses carried."""

from reid_bench.program_spans import median_ms


def read(run):
    return median_ms(run, "serve.lock_wait")
