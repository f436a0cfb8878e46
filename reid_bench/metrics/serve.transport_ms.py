"""The time a request spends outside the daemon's handler: the client's
wall from send to response less the response's ``ms`` (the socket, JSON
lines, inline npz both ways), median over the window."""

import statistics


def read(run):
    transport = run.counters.get("transport_ms")
    return statistics.median(transport) if transport else None
