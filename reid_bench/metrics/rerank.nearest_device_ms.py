"""The card's time per request for ordering every row of the distances
(the argsort): the median ``device_ms`` of the ``rerank.nearest`` spans
that the traced responses carried; ``None`` on the CPU."""

from reid_bench.program_spans import median_device_ms


def read(run):
    return median_device_ms(run, "rerank.nearest")
