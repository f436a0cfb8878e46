"""On the card, at each cell's own size: the program's run is correct and
its control (the plain reference at the precision below the cell's, in
the program's place) is not. ``python -m pytest -q -m cuda
reid_bench/tests`` on a machine with a card; skips without one."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from reid_bench import run
from reid_bench.control import CONTROLS
from reid_bench.trace import Spans

BENCH = json.loads((Path(run.__file__).resolve().parents[1] / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_the_program_is_correct_and_its_control_is_not(cell, card):
    import importlib

    wl = run.workload(cell)
    kind = importlib.import_module(f"reid_bench.traffic.{wl['traffic']}")
    ctx = run.Context(cell, wl, run.config(wl["config"]), 2**31 + 99, 3.0, False, card, time.time(), Spans())
    out = kind.run(ctx, **CONTROLS[wl["traffic"]])
    assert out.correct
    readings = out.control["tf32"] if wl["traffic"] == "pair_train" else out.control
    assert any(readings[k] > limit for k, (_, limit) in out.checks.items() if k in readings)
