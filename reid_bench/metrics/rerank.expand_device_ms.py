"""The card's time per request for the k-reciprocal sets and their
expansion (both adjacencies and the two 0/1 products): the median
``device_ms`` of the ``rerank.expand`` spans that the traced responses
carried; ``None`` on the CPU."""

from reid_bench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "rerank.expand")
