"""How long the daemon holds its index lock per re-ranked request (the
re-ranking, the reads and the response's matches): the median length of
the ``serve.lock_held`` spans that the traced responses carried."""

from reid_bench.program_spans import median_ms


def read(run):
    return median_ms(run, "serve.lock_held")
