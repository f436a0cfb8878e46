"""Device time per answered re-ranked request in the daemon's process:
the union of its kernels', copies' and memsets' intervals in the traced
window over the requests answered in it."""


def read(run):
    if "handler_ms" not in run.counters or run.device_trace is None or not run.counters["requests"]:
        return None
    busy = run.device_trace.busy_s()
    return 1e3 * busy / run.counters["requests"] if busy > 0 else None
