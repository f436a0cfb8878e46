#!/usr/bin/env python3
"""The serve daemon's describe under 6 concurrent clients, two trees of the
port side by side on one card (the record behind PERF.md §5's C4 table).

    python3 docs/serve_c4/serve_ab.py --parent build/parent --out build/c4
    python3 docs/serve_c4/serve_ab.py --graphs-only --out build/c4

``--parent`` is an unpacked checkout of another commit (``git archive``);
the change is the checkout this script lies in. It writes a full-width
random checkpoint and exports it at batch 8 and 32 (8 x 256x128 RGB clips),
fp32 and bf16, with the change's code; both trees load the same artifacts.
``graphs``: each artifact loaded in this process by the change (load
seconds, the CUDA graph's pool bytes, one call's ms and CPU ms in turn
beside the eager program's). Then, on the fp32 artifacts, in the order
parent, change, change, parent, for each batch:

- ``in_process``: ``python -m grl_tpu_torch.tools.measure_serve_concurrency
  --model M`` run from inside the tree (its daemon and its 6 clients share
  one process), its JSON line as printed;
- ``processes``: the tree's daemon (``serve --listen unix:``, the tool's
  way: ``cli.extract.serve`` with the tool's ``Timeline`` around it) in a
  process of its own, then 48 one-clip describes in turn from one client
  process and 6 client processes x 8 started together. Two passes, as the
  tool: the headline without the probe, then the timeline (SIGUSR1 turns
  it on, SIGUSR2 writes its summary). The daemon's ``describe_batching``
  counters are read around each phase.

Each run's record is one line of ``OUT/runs.jsonl``; ``OUT/summary.json``
gathers the ratios, dispatch walls and the leader's CPU per dispatch.
``--graphs-only`` exports and runs ``graphs`` alone, into ``OUT/graphs.json``.
"""

from __future__ import annotations

import argparse
import json
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

CLIENTS, REPS = 6, 8

DAEMON = r"""
import json, os, signal, sys
from grl_tpu_torch.cli.extract import build_parser, serve
from grl_tpu_torch.tools.measure_serve_concurrency import Timeline

ctl, argv = sys.argv[1], sys.argv[2:]
with Timeline() as tl:
    def on(*_):
        tl.reset()
        tl.on = True
        open(ctl + ".on", "w").close()

    def off(*_):
        tl.on = False
        with open(ctl + ".tmp", "w") as f:
            json.dump(tl.summary(), f)
        os.replace(ctl + ".tmp", ctl + ".json")

    signal.signal(signal.SIGUSR1, on)
    signal.signal(signal.SIGUSR2, off)
    serve(build_parser().parse_args(argv))
"""

CLIENT = r"""
import json, sys, time
import numpy as np
from grl_tpu_torch.client import ServeClient

address, reps = sys.argv[1], int(sys.argv[2])
with ServeClient.connect(address, timeout=1200) as c:
    meta = c.ping()
    clip = np.random.RandomState(0).randint(
        0, 256, (1, meta["seq_len"], meta["height"], meta["width"], meta["channels"]), np.uint8)
    print("ready", flush=True)
    sys.stdin.readline()
    t0 = time.time()
    for _ in range(reps):
        c.describe(clip)
    t1 = time.time()
print(json.dumps({"t0": t0, "t1": t1}), flush=True)
"""


def run(cmd, cwd, timeout=1200):
    out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{cmd} in {cwd} exited {out.returncode}: {out.stderr[-4000:]}")
    return out.stdout


def artifacts(build):
    """The full-width random checkpoint exported at batch 8 and 32, fp32 and
    bf16: ``{(dtype, batch): path}``."""
    build.mkdir(parents=True, exist_ok=True)
    ckpt = build / "ckpt.npz"
    run([sys.executable, "-m", "grl_tpu_torch.tools.make_random_checkpoint", "-o", str(ckpt),
         "--num-classes", "625"], ROOT)
    models = {}
    for dtype in ("fp32", "bf16"):
        for batch in (8, 32):
            models[dtype, batch] = build / f"model_{dtype}_b{batch}.npz"
            t0 = time.perf_counter()
            run([sys.executable, "-m", "grl_tpu_torch.cli.extract", "export-model", "--checkpoint", str(ckpt),
                 "--num-classes", "625", "--batch", str(batch), "--seq_len", "8", "--height", "256", "--width",
                 "128", "-o", str(models[dtype, batch]), *(["--bf16"] if dtype == "bf16" else [])], ROOT)
            print(f"exported {dtype} batch {batch} in {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    ckpt.unlink()
    return models


def graphs(models, reps=20):
    """Each artifact loaded in this process with the change's
    ``_load_artifact`` (the CLIs' precision policy): load seconds, the graph
    pool's bytes, and in turn the wall and thread CPU ms of one call, the
    graph's against the eager program called the parent's way."""
    import io

    import numpy as np
    import torch

    from grl_tpu_torch import set_precision
    from grl_tpu_torch.cli.extract import _load_artifact

    set_precision()
    out = []
    for (dtype, batch), path in models.items():
        t0 = time.perf_counter()
        call, meta = _load_artifact(str(path), "cuda")
        load_s = time.perf_counter() - t0
        with np.load(path) as z:
            program = torch.export.load(io.BytesIO(z["exported"].tobytes())).module()

        def eager(chunk):
            with torch.inference_mode():
                return program(torch.from_numpy(np.ascontiguousarray(chunk)).to("cuda")).to(
                    torch.float32).cpu().numpy()

        chunk = np.random.RandomState(0).randint(0, 256, call.shape, np.uint8)
        row = {"dtype": dtype, "batch": batch, "load_s": load_s, "pool_bytes": call.pool_bytes}
        for name, fn in (("graph", call), ("eager", eager), ("graph_again", call)):
            fn(chunk)
            walls, cpus = [], []
            for _ in range(reps):
                t0, c0 = time.perf_counter(), time.thread_time()
                fn(chunk)
                walls.append(1e3 * (time.perf_counter() - t0))
                cpus.append(1e3 * (time.thread_time() - c0))
            row[name] = {"ms": statistics.median(walls), "cpu_ms": statistics.median(cpus),
                         "ms_range": [min(walls), max(walls)]}
        row["graph_vs_eager_max_abs"] = float(np.abs(call(chunk) - eager(chunk)).max())
        out.append(row)
        print(json.dumps(row), flush=True)
        del call, program
        torch.cuda.empty_cache()
    return out


def in_process(tree, model):
    lines = run([sys.executable, "-m", "grl_tpu_torch.tools.measure_serve_concurrency", "--model",
                 str(model)], tree).strip().splitlines()
    return json.loads(lines[-1])


def clients(tree, address, n, reps):
    """``n`` client processes, each connected and ready, then started at
    once; returns the wall from the first one's start to the last one's end."""
    procs = [subprocess.Popen([sys.executable, "-c", CLIENT, address, str(reps)], cwd=tree, text=True,
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE) for _ in range(n)]
    for p in procs:
        if p.stdout.readline().strip() != "ready":
            raise RuntimeError("a client process did not connect")
    for p in procs:
        p.stdin.write("go\n")
        p.stdin.flush()
    times = []
    for p in procs:
        out, _ = p.communicate(timeout=1200)
        if p.returncode != 0:
            raise RuntimeError(f"a client process exited {p.returncode}")
        times.append(json.loads(out.strip().splitlines()[-1]))
    return max(t["t1"] for t in times) - min(t["t0"] for t in times)


def processes(tree, model, work):
    from grl_tpu_torch.client import ServeClient

    sock, ctl = work / "d.sock", work / "timeline"
    for path in (sock, Path(f"{ctl}.on"), Path(f"{ctl}.json")):
        path.unlink(missing_ok=True)
    daemon = subprocess.Popen([sys.executable, "-c", DAEMON, str(ctl), "--device", "cuda", "serve", "--model",
                               str(model), "--listen", f"unix:{sock}", "--warmup"], cwd=tree)
    try:
        t0 = time.perf_counter()
        while not sock.exists():
            if daemon.poll() is not None or time.perf_counter() - t0 > 600:
                raise RuntimeError("the daemon did not come up")
            time.sleep(0.05)
        ready_s = time.perf_counter() - t0
        address = f"unix:{sock}"
        with ServeClient.connect(address, timeout=1200) as c:
            meta = c.ping()
            clip_shape = (1, meta["seq_len"], meta["height"], meta["width"], meta["channels"])
            import numpy as np

            c.describe(np.zeros(clip_shape, np.uint8))  # any first-call cost lands before the timing

            def phase(n, reps, probe):
                if probe:
                    daemon.send_signal(signal.SIGUSR1)
                    while not Path(f"{ctl}.on").exists():
                        time.sleep(0.01)
                s0 = c.stats()["describe_batching"]
                wall = clients(tree, address, n, reps)
                s1 = c.stats()["describe_batching"]
                out = {"wall_s": wall, **{k: s1[k] - s0[k] for k in s0}}
                if probe:
                    daemon.send_signal(signal.SIGUSR2)
                    while not Path(f"{ctl}.json").exists():
                        time.sleep(0.01)
                    out["timeline"] = json.loads(Path(f"{ctl}.json").read_text())
                    Path(f"{ctl}.on").unlink()
                    Path(f"{ctl}.json").unlink()
                return out

            seq, conc = phase(1, CLIENTS * REPS, False), phase(CLIENTS, REPS, False)
            seq["timeline"] = phase(1, CLIENTS * REPS, True)
            conc["timeline"] = phase(CLIENTS, REPS, True)
            c.shutdown()
        daemon.wait(timeout=120)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
    return {"batch": meta["batch"], "ready_s": ready_s, "sequential": seq, "concurrent": conc,
            "speedup": seq["wall_s"] / max(conc["wall_s"], 1e-9)}


def headline(rec):
    """ratio, and per phase the probed pass's mean dispatch and leader CPU (ms)."""
    out = {"speedup": rec["speedup"]}
    for ph in ("sequential", "concurrent"):
        tl = rec[ph]["timeline"]
        tl = tl.get("timeline", tl)
        out[ph] = {k: 1e3 * tl[k]["mean"] for k in ("dispatch_s", "dispatch_cpu_s", "handoff_s", "gap_s")
                   if tl.get(k, {}).get("n")}
        out[ph]["dispatches"] = rec[ph]["dispatches"]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of the commit to compare with")
    ap.add_argument("--out", required=True)
    ap.add_argument("--graphs-only", action="store_true", help="only the artifacts' graphs, in this process")
    args = ap.parse_args()
    if not args.graphs_only and not args.parent:
        ap.error("--parent is required unless --graphs-only")
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    build = ROOT / "build" / "serve_c4"
    models = artifacts(build)
    if args.graphs_only:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()
        (out / "graphs.json").write_text(json.dumps({"nvidia_smi": smi, "graphs": graphs(models)}, indent=1))
        for path in models.values():
            path.unlink()
        return
    trees = {"parent": Path(args.parent).resolve(), "change": ROOT}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    summary = {"nvidia_smi": smi, "graphs": graphs(models), "runs": []}
    with open(out / "runs.jsonl", "w") as f:
        for i, which in enumerate(("parent", "change", "change", "parent")):
            for batch in (8, 32):
                model = models["fp32", batch]
                for kind in ("in_process", "processes"):
                    t0 = time.perf_counter()
                    rec = (in_process(trees[which], model) if kind == "in_process"
                           else processes(trees[which], model, build))
                    line = {"run": i, "tree": which, "batch": batch, "kind": kind,
                            "seconds": time.perf_counter() - t0, "nvidia_smi": smi, "result": rec}
                    f.write(json.dumps(line) + "\n")
                    f.flush()
                    summary["runs"].append({k: line[k] for k in ("run", "tree", "batch", "kind")} | headline(rec))
                    print(json.dumps(summary["runs"][-1]), flush=True)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    for path in models.values():
        path.unlink()


if __name__ == "__main__":
    main()
