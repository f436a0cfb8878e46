"""The daemon's own time per answered request (each response's ``ms``,
which includes its wait for the index lock), median over the window."""

import statistics


def read(run):
    handler = run.counters.get("handler_ms")
    return statistics.median(handler) if handler else None
