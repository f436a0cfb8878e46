"""The harness's host spans and the device trace of a window.

Spans are the harness's own, around its calls into the system: a name
and its start and end on the wall clock in nanoseconds, the clock the
profiler stamps its events with. The device trace is ``torch.profiler``
over the window, recording device activity only (kernels, copies,
memsets; on a host without a card, the host's operators stand in, which
the CPU tests use).
"""

from __future__ import annotations

import contextlib
import time

import torch

TOP = 10


class Spans:
    def __init__(self):
        self.done = []  # (name, start_ns, end_ns)

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.time_ns()
        try:
            yield
        finally:
            self.done.append((name, start, time.time_ns()))

    def labeler(self):
        """A function of a time (called with times that never decrease) ->
        the innermost span open then (the latest started), or ``"none"``."""
        spans = sorted(self.done, key=lambda sp: sp[1])
        nxt, active = 0, []

        def label(t_ns):
            nonlocal nxt, active
            while nxt < len(spans) and spans[nxt][1] <= t_ns:
                active.append(spans[nxt])
                nxt += 1
            active = [sp for sp in active if sp[2] > t_ns]
            return max(active, key=lambda sp: sp[1])[0] if active else "none"

        return label


class Timeline:
    """Device activity ``events`` (``(name, start_ns, end_ns)``, sorted by
    start) over a window ``[start_ns, end_ns)``."""

    def __init__(self, events, start_ns, end_ns):
        self.events = sorted(events, key=lambda e: e[1])
        self.start_ns = start_ns
        self.end_ns = end_ns

    @property
    def window_s(self):
        return (self.end_ns - self.start_ns) / 1e9

    def busy_intervals(self):
        """The union of the events' intervals inside the window, merged."""
        out = []
        for _, s, e in self.events:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def seconds_where(self, match):
        """Summed seconds of the events whose name ``match`` accepts."""
        return sum(e - s for n, s, e in self.events if match(n)) / 1e9

    def breakdown(self, spans):
        """The device operations that took most time, by name, and the idle
        time between them summed by the host span open where each gap
        began: ``{"device_ops": [[name, s], ...], "idle_gaps": [...]}``."""
        by_op = {}
        for n, s, e in self.events:
            by_op[n] = by_op.get(n, 0) + (e - s)
        gaps, last, label = {}, self.start_ns, spans.labeler()
        for s, e in self.busy_intervals() + [[self.end_ns, self.end_ns]]:
            if s > last:
                where = label(last)
                gaps[where] = gaps.get(where, 0) + (s - last)
            last = max(last, e)

        def top(d):
            return [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


class DeviceTrace:
    """``with DeviceTrace(device) as tr:`` profiles the block; then
    ``tr.timeline`` is its device activity over the block."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.device(device).type == "cuda"
        activity = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
        self._prof = profile(activities=[activity])
        self.timeline = None

    def __enter__(self):
        self._prof.__enter__()
        self._start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self._prof.__exit__(*exc)
        wanted = torch.autograd.DeviceType.CUDA if self.cuda else torch.autograd.DeviceType.CPU
        events = [(ev.name(), ev.start_ns(), ev.end_ns()) for ev in self._prof.profiler.kineto_results.events()
                  if ev.device_type() == wanted and ev.duration_ns() > 0]
        self.timeline = Timeline(events, self._start, end)
        return False
