"""The share of the traced training window in which no kernel, copy or
memset ran on the card."""


def read(run):
    if "step" not in run.ops or run.device_trace is None:
        return None
    return 100.0 * (1.0 - run.device_trace.busy_s() / run.device_trace.window_s)
