"""BENCHMARK.json and every file it names hold the benchmark's contract:
keys, names, units, bounds, cells found by name, each configuration,
workload, traffic kind and metric reader in a file of its own."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from reid_bench import run

ROOT = Path(run.__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["reid_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


def test_names_units_and_lines():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if m["name"] != "setup_s" and cell in m.get("workloads", cells)]
        assert reported, f"{cell} reports no end-to-end metric besides setup_s"


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
        assert (ROOT / "reid_bench" / "metrics" / f"{m['name']}.py").exists()
        assert callable(run.metric_reader(m["name"]))
    for cell in cells:
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    wl = run.workload(cell)
    assert set(wl) == {"config", "traffic", "chips", "precision", "why", "params", "limits"}
    assert (wl["config"], wl["traffic"], wl["chips"], wl["why"]) == (
        entry["config"], entry["traffic"], entry["chips"], entry["why"])
    assert entry["chips"] == 1
    assert (ROOT / "reid_bench" / "traffic" / f"{wl['traffic']}.py").exists()
    assert wl["limits"] and all(v > 0 for v in wl["limits"].values())


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"reid_bench/configs/{config}.json"
    cfg = run.config(config)
    assert cfg["name"] == config and entry["reduced"] == []
    assert cfg["feat_dim"] == cfg["trunk_width"] * 32 and cfg["descriptor_dim"] == 3 * cfg["feat_dim"]
    assert any(w["config"] == config for w in BENCH["workloads"])


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
