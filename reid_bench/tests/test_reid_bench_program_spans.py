"""The metrics that read the program's own spans (``reid_bench/program_spans.py``
and its eleven readers): each cell's traced run at small sizes on the CPU
gives its new metrics, every reader gives nothing where the program
recorded no spans, and the idle split by the innermost program span is
the hand-computed interval overlap."""

from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from grl_tpu_torch.utils import profiling
from grl_tpu_torch.utils.profiling import Span
from reid_bench import program_spans, run
from reid_bench.tests.conftest import tiny
from reid_bench.trace import Timeline

ROOT = Path(run.__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = [m for m in BENCH["per_layer"] if m["source"] == "program_span" and m["name"] not in
       ("data.wait.train", "serve.handler_ms")]
KIND = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
SEED = 2**31 + 777
DEVICE_ONLY = {"rerank.expand_device_ms", "rerank.nearest_device_ms"}  # CUDA events: none on the CPU


def test_the_eleven_metrics_are_declared():
    assert len(NEW) == 11 and all(len(m["workloads"]) == 1 for m in NEW)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_traced_run_of_each_cell_gives_its_new_metrics(cell):
    result, _ = run.execute(cell, SEED, 0.5, 1, "cpu", overrides=tiny(KIND[cell]))
    want = {m["name"] for m in NEW if cell in m["workloads"]}
    assert want and result["correct"]
    got = {name for name in want if name in result["metrics"]}
    assert got == want - DEVICE_ONLY
    for name in got:
        value = result["metrics"][name]["value"]
        assert value >= 0 and (value <= 100 or result["metrics"][name]["unit"] != "%")


def _run(timeline):
    return SimpleNamespace(device_trace=timeline, counters={}, ops={}, window_s=1.0)


@pytest.mark.parametrize("metric", [m["name"] for m in NEW])
def test_every_reader_gives_nothing_without_program_spans(metric, monkeypatch):
    profiling.clear()
    timeline = Timeline([("k", 10, 20)], 0, 100)
    read = run.metric_reader(metric)
    assert read(_run(timeline)) is None and read(_run(None)) is None
    # a program without the recorder (the parent of this change)
    monkeypatch.setitem(sys.modules, "grl_tpu_torch.utils.profiling", None)
    assert read(_run(timeline)) is None


def span(name, s, e, sid, parent=None):
    return Span(name, s, e, sid, parent, sid if parent is None else 1, 0, None)


def test_the_idle_split_is_the_exact_overlap_with_the_innermost_span():
    # window [0, 100); busy [10, 20) and [55, 60): idle [0, 10), [20, 55), [60, 100)
    timeline = Timeline([("a", 10, 20), ("b", 55, 60), ("c", 12, 18)], 0, 100)
    spans = [
        span("root", 5, 90, 1),
        span("outer", 15, 50, 2, 1),
        span("inner", 30, 40, 3, 2),  # nested: wins over "outer" inside [30, 40)
        span("next", 45, 70, 4, 1),   # straddles the gap [20, 55) with "outer"
    ]
    got = program_spans.idle_by_span(timeline, spans)
    assert got == {
        "none": 5 + 10,                 # [0, 5) and [90, 100)
        "root": 5 + 20,                 # [5, 10) and [70, 90)
        "outer": (30 - 20) + (45 - 40),  # [20, 30) and [40, 45): "next" starts later at the same depth
        "inner": 10,                    # [30, 40)
        "next": (55 - 45) + (70 - 60),  # [45, 55) and [60, 70)
    }
    assert sum(got.values()) == 100 - (20 - 10) - (60 - 55)


def test_share_and_medians_read_the_window_only():
    profiling.clear()
    profiling.record([span("trainer.iteration", 0, 50, 1), span("trainer.read", 10, 30, 2, 1),
                      span("trainer.read", 200, 300, 3)])  # outside the window
    profiling.record([Span("rerank.expand", 40, 45, 5, None, 5, 0, 3.0), Span("rerank.expand", 41, 49, 6, None, 6,
                                                                              0, 5.0)])
    try:
        r = _run(Timeline([("k", 0, 10)], 0, 100))
        assert program_spans.idle_share(r, "trainer.iteration", "trainer.read") == 20.0
        assert program_spans.median_ms(r, "trainer.read") == 20 / 1e6
        assert program_spans.median_device_ms(r, "rerank.expand") == 4.0
        assert program_spans.idle_share(r, "evaluator.extract_features", "evaluator.pack") is None
    finally:
        profiling.clear()
