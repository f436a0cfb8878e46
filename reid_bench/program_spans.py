"""The program's own spans in a traced run, and the window's device idle
time split by them.

The program (``grl_tpu_torch.utils.profiling``) records spans only while
a ``torch.profiler`` session is active in its process, so they cover the
traced window: the harness's process in the index and training cells, the
daemon's in the serving cell, whose traced responses carry their spans
back to the client in this process. Times are ``time.time_ns()``, the
clock of the device trace's events and window. A program without the
recorder gives no spans, and each reader then ``None``.
"""

from __future__ import annotations

import statistics

NONE = "none"  # idle time under no program span


def in_window(run):
    """The program's spans that overlap the traced window (``[]`` without a
    device trace or a recorder)."""
    if run.device_trace is None:
        return []
    try:
        from grl_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    lo, hi = run.device_trace.start_ns, run.device_trace.end_ns
    return [sp for sp in spans() if sp.end_ns > lo and sp.start_ns < hi]


def _depths(spans):
    """Each span's number of ancestors among ``spans``."""
    parent = {sp.span_id: sp.parent_id for sp in spans}
    depth = {}

    def of(span_id):
        if span_id not in depth:
            up = parent.get(span_id)
            depth[span_id] = 0 if up not in parent else 1 + of(up)
        return depth[span_id]

    return {sp.span_id: of(sp.span_id) for sp in spans}


def innermost_segments(spans, lo, hi):
    """``[(start, end, name)]`` covering ``[lo, hi)``: at each instant the
    innermost open span, the deepest, of equals the latest started
    (``NONE`` where none is open)."""
    depth = _depths(spans)
    points = []
    for i, sp in enumerate(spans):
        s, e = max(sp.start_ns, lo), min(sp.end_ns, hi)
        if e > s:
            points += [(s, 1, i), (e, 0, i)]
    points.sort()
    out, active, t, top = [], set(), lo, NONE
    for when, starts, i in points:
        if when > t:
            out.append((t, when, top))
            t = when
        (active.add if starts else active.discard)(i)
        inner = max(active, key=lambda j: (depth[spans[j].span_id], spans[j].start_ns, j), default=None)
        top = NONE if inner is None else spans[inner].name
    if hi > t:
        out.append((t, hi, top))
    return out


def idle_by_span(timeline, spans):
    """``{name: idle ns}``: the window's device idle time (the complement
    of ``timeline.busy_intervals()``) by the innermost span open at each
    instant, as exact interval overlaps."""
    lo, hi = timeline.start_ns, timeline.end_ns
    idle, last = [], lo
    for s, e in timeline.busy_intervals():
        if s > last:
            idle.append((last, s))
        last = max(last, e)
    if hi > last:
        idle.append((last, hi))
    out, k = {}, 0
    for s, e, name in innermost_segments(spans, lo, hi):
        while k < len(idle) and idle[k][1] <= s:
            k += 1
        j = k
        while j < len(idle) and idle[j][0] < e:
            overlap = min(e, idle[j][1]) - max(s, idle[j][0])
            if overlap > 0:
                out[name] = out.get(name, 0) + overlap
            j += 1
    return out


def idle_share(run, root, name):
    """The share of the traced window, in %, in which the card was idle
    while ``name`` was the innermost program span open; ``None`` without
    ``root`` spans in the window."""
    spans = in_window(run)
    if not any(sp.name == root for sp in spans):
        return None
    tl = run.device_trace
    return 100.0 * idle_by_span(tl, spans).get(name, 0) / (tl.end_ns - tl.start_ns)


def median_ms(run, name):
    """The median length in ms of the window's ``name`` spans, or ``None``."""
    lengths = [(sp.end_ns - sp.start_ns) / 1e6 for sp in in_window(run) if sp.name == name]
    return statistics.median(lengths) if lengths else None


def median_device_ms(run, name):
    """The median device time in ms of the window's ``name`` spans, or
    ``None`` where none has one (on the CPU)."""
    times = [sp.device_ms for sp in in_window(run) if sp.name == name and sp.device_ms is not None]
    return statistics.median(times) if times else None
