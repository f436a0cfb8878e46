"""The share of the traced serving window in which no kernel, copy or
memset ran on the card (the daemon's process)."""


def read(run):
    if "handler_ms" not in run.counters or run.device_trace is None:
        return None
    busy = run.device_trace.busy_s()
    return 100.0 * (1.0 - busy / run.device_trace.window_s) if busy > 0 else None
