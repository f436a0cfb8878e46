"""One run of one cell:

    python -m reid_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's file ``reid_bench/workloads/<cell>.json`` names its
configuration (``reid_bench/configs/<config>.json``), its traffic kind
(``reid_bench/traffic/<kind>.py``, a module with ``run(ctx)``), the chips
it needs, its precision, the kind's parameters and the limits of the
numbers its check compares. ``BENCHMARK.json`` lists the metrics: a cell
reports ``setup_s`` and each end-to-end metric that names it (with
``--trace 0``), or each per-layer metric that names it, or names no cell
(with ``--trace 1``), read by ``reid_bench/metrics/<metric>.py``'s
``read(run)``. Adding a cell, a kind or a metric adds files; none of
these is edited.

The run prints one JSON object as the last line of its standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` when traced, and last ``checks``: each compared number with
its limit), and the checks again as the last lines of standard error. It
exits non-zero with no result when the cell's chips are not there, and
when JAX or the JAX package is loaded once the window has closed, in this
process or in a process of the system that the cell started (the serving
cells' daemon, which reports its own modules).
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "grl_tpu")


class Context:
    """What a traffic kind's ``run`` gets: the cell (``workload``,
    ``config``, ``params``), ``seed``, ``seconds``, ``trace``, ``device``,
    the harness's ``spans`` and the process's start time ``t0``."""

    def __init__(self, name, workload, config, seed, seconds, trace, device, t0, spans):
        self.name = name
        self.workload = workload
        self.config = config
        self.params = workload["params"]
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.device = device
        self.t0 = t0
        self.spans = spans

    def rng(self, stream):
        """A ``RandomState`` for one stream of this run's draws."""
        return np.random.RandomState(self.subseed(stream))

    def subseed(self, stream):
        """A 31-bit seed for one stream of this run's draws."""
        return int(np.random.SeedSequence([self.seed, stream]).generate_state(1)[0] >> 1)


class Outcome:
    """What a kind's ``run`` returns: ``end_to_end`` values by metric name,
    ``setup_s``, ``attempted``/``failed``, ``checks`` as ``{name: (value,
    limit)}``, ``memory_peak_bytes``, the window's ``window_s`` and
    ``counters``, the operations counted from shapes (``ops``), the
    ``device_trace`` of a traced run, and ``forbidden``: the modules of
    ``FORBIDDEN`` loaded in the system's other processes once the window
    had closed."""

    def __init__(self, **kw):
        self.end_to_end = {}
        self.counters = {}
        self.ops = {}
        self.device_trace = None
        self.forbidden = []
        self.__dict__.update(kw)

    @property
    def correct(self):
        return all(v <= limit for v, limit in self.checks.values())


def load_json(path):
    with open(path) as f:
        return json.load(f)


def workload(name):
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name):
    return load_json(HERE / "configs" / f"{name}.json")


def metric_reader(name):
    spec = importlib.util.spec_from_file_location(f"reid_bench_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _listed(metric, cell):
    return cell in metric.get("workloads", [cell])


def execute(name, seed, seconds, trace, device, t0=None, overrides=None, bench=None):
    """Run cell ``name`` once on ``device`` and return ``(result, outcome)``.
    ``overrides`` replaces keys of the configuration and of the kind's
    parameters (``{"config": {...}, "params": {...}}``: the CPU tests'
    small sizes); ``bench`` stands for ``BENCHMARK.json``."""
    from .trace import Spans

    t0 = time.time() if t0 is None else t0
    bench = load_json(ROOT / "BENCHMARK.json") if bench is None else bench
    wl = workload(name)
    cfg = config(wl["config"])
    overrides = overrides or {}
    cfg.update(overrides.get("config", {}))
    wl["params"].update(overrides.get("params", {}))
    wl["limits"].update(overrides.get("limits", {}))
    ctx = Context(name, wl, cfg, seed, seconds, bool(trace), device, t0, Spans())
    kind = importlib.import_module(f"reid_bench.traffic.{wl['traffic']}")
    out = kind.run(ctx)

    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if _listed(m, name):
                value = metric_reader(m["name"])(out)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": out.setup_s, "unit": m["unit"]}
            elif _listed(m, name) and m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": _device_kind(device),
           "count": wl["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.device_trace is not None:
        dev["busy_s"] = out.device_trace.busy_s()
        dev["window_s"] = out.device_trace.window_s
        result["breakdown"] = out.device_trace.breakdown(ctx.spans)
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in out.checks.items()}
    return result, out


def _device_kind(device):
    import torch

    return torch.cuda.get_device_name(0) if device == "cuda" else device


def parse(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell of grl_tpu_torch")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t0=None):
    args = parse(argv)
    import torch

    chips = workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"reid_bench: cell {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result, out = execute(args.workload, args.seed, args.seconds, args.trace, "cuda", t0=t0)
    loaded = {"this process": forbidden_modules(), "the system's other processes": out.forbidden}
    if any(loaded.values()):
        print("reid_bench: JAX or the JAX package was loaded: "
              + "; ".join(f"{', '.join(v)} in {k}" for k, v in loaded.items() if v), file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
