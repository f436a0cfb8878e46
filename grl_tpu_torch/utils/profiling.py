"""The port's spans, and the tools' timing helpers.

Spans (grl_tpu has no counterpart): ``span(name)`` marks a block of the
program with its start and end on the wall clock (``time.time_ns()``,
the clock ``torch.profiler`` stamps device activity with), its parent
(the innermost span open on the same thread), its request (the root
span's id) and, with ``device=`` a CUDA device, the card's own time of
the work the block enqueued (a pair of timing CUDA events on the
device's current stream).
Spans are recorded only while a ``torch.profiler`` session is active in
the process, so they cover exactly the window of a device trace; outside
one ``span`` returns a shared no-op and reads no clock. They are kept in
memory (``spans``, ``record``, ``clear``, ``dropped``), never annotated
on the device timeline: an annotation there would count as device time.

It also holds the card's peaks, which ``chip_smoke.py`` and
``tools/profile_train_step.py`` compute their bounds and roofline shares
against, and the tools' helpers: ``card_line`` (the card's name and power
limit), ``sync`` and ``window_ms`` (one timed window of calls). grl_tpu's
``trace``, ``ThroughputMeter``, ``enable_compilation_cache`` and
``descriptor_compiler_options`` have no counterpart here.
"""

from __future__ import annotations

import collections
import itertools
import os
import subprocess
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

# NVIDIA H100 80GB HBM3 (SXM5, 700 W) data sheet: dense bf16 and dense int8
# on the tensor cores (the sheet's 1,979 TFLOPS and 3,958 TOPS are with
# sparsity, twice the dense rates), fp32 outside them, and device memory
# bandwidth
PEAK_BF16_OPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12


def card_line(device):
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them; a CPU device
    names itself instead."""
    if torch.device(device).type != "cuda":
        return f"{device}: no card"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(device):
    """Wait for the work queued on ``device`` (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window_ms(fn, iters, device):
    """Milliseconds of one window of ``iters`` calls of ``fn()``: between
    two CUDA events on a card (the work queued before it finished first),
    on the host clock on the CPU."""
    if torch.device(device).type == "cuda":
        sync(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3


# -- spans --------------------------------------------------------------------

MAX_SPANS = 1 << 20  # the buffer's bound: past it the oldest spans are dropped


class Span(NamedTuple):
    """A finished span: times in ns on ``time.time_ns()``'s clock; ids
    unique across processes (the process id in the high bits); ``parent``
    None for a root; ``device_ms`` the card's time between the block's
    two events, None without them."""

    name: str
    start_ns: int
    end_ns: int
    span_id: int
    parent_id: int | None
    request_id: int
    thread_id: int
    device_ms: float | None


_buffer = collections.deque(maxlen=MAX_SPANS)  # records: lists in Span's order
_lock = threading.Lock()
_open = threading.local()  # .stack: the spans open on this thread
_ids = itertools.count((os.getpid() << 32) + 1)
_dropped = 0


def _append(rec):
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(rec)


def _resolved(rec):
    """The record as a ``Span``, its CUDA events turned into milliseconds
    (waiting for the end event if the work is still queued)."""
    events = rec[7]
    if isinstance(events, tuple):
        begin, end = events
        if not end.query():
            end.synchronize()
        rec[7] = begin.elapsed_time(end)
    return Span(*rec)


class _Span:
    __slots__ = ("name", "cuda", "span_id", "parent_id", "request_id", "start_ns", "events", "finished")

    def __init__(self, name, cuda):
        self.name, self.cuda = name, cuda
        self.finished = []  # records of the spans that ended under this one while it was a root

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        self.span_id = next(_ids)
        self.parent_id = None if parent is None else parent.span_id
        self.request_id = self.span_id if parent is None else parent.request_id
        stack.append(self)
        self.start_ns = time.time_ns()
        self.events = None
        if self.cuda is not None:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.cuda))
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.cuda))
        end = time.time_ns()
        stack = _open.stack
        stack.pop()
        rec = [self.name, self.start_ns, end, self.span_id, self.parent_id, self.request_id,
               threading.get_ident(), self.events]
        _append(rec)
        if stack:
            stack[0].finished.append(rec)
        return False

    def descendants(self):
        """The spans that ended under this root span so far, resolved."""
        return [_resolved(rec) for rec in self.finished]


class _NoSpan:
    """What ``span`` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def descendants(self):
        return []


_NO_SPAN = _NoSpan()


def span(name, device=None):
    """A context manager that records the block as a span named ``name``
    while a ``torch.profiler`` session (a CPU or a CUDA-only one) is active
    in this process, and a shared no-op otherwise.

    ``device``: the device the block's work runs on, or None; on a CUDA
    device the span also records a timing event on its current stream at
    each end, and ``device_ms`` is the time between them, read when the
    spans are read."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    cuda = None
    if device is not None:
        dev = torch.device(device)
        cuda = dev if dev.type == "cuda" else None
    return _Span(name, cuda)


def spans():
    """Every recorded span still in the buffer, oldest first."""
    with _lock:
        recs = list(_buffer)
    return [_resolved(rec) for rec in recs]


def record(foreign):
    """Add spans recorded in another process (``Span``s or lists in its
    order, as a traced serve response carries them)."""
    for item in foreign:
        _append(list(item))


def clear():
    """Empty the buffer and its count of dropped spans."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0


def dropped():
    """Spans dropped from the buffer's front since the last ``clear``."""
    return _dropped
