"""Re-ranked retrieval: ``rank`` requests with ``rerank: true`` and
``features`` to the system's ``serve`` daemon, open loop.

Set-up exports the descriptor artifact once per checkout (a random-init
checkpoint by the system's tools, ``export-model`` at ``export_batch``;
kept under ``build/reid_bench/`` keyed by a digest of the system's sources
and the configuration), starts the daemon in a process of its own
(``reid_bench.daemon``: ``serve --listen unix:...`` in ``TMPDIR``, at the
configuration's gallery size as ``--capacity``), enrolls the gallery by
``add`` in blocks, and warms the re-ranked path.

The gallery is ``gallery_size`` unit vectors clustered by identity (an id's
rows lie around its centre at cosine ~ 1 / sqrt(1 + spread^2)); queries
are drawn the same way. Arrivals are Poisson at ``rate``, each request
with a uniform 1..``q_max`` queries: one seeded arrival sequence for every
run, and one seeded multiset of sizes in an order drawn from the run's
seed. ``connections``
clients send them; each request is timed from when it was due.

``rank_p95_ms``: the 95th percentile over the window's requests (a failed
one counts as an hour). The check re-ranks ``sample`` of the answered
requests, drawn from the seed, and the largest, with the plain reference
in fp64 against the same gallery: ``served_off`` is the share of the
(query, rank) entries of the top-k that are off (``off_entries``): missing,
a repeat, an item that lies more than ``OFF`` beyond the reference's k-th
nearest (not among the top k), or one served at a score more than ``OFF``
from the reference's negated distance; ``failed_requests`` counts the
errors. The reference is fp64 because k-reciprocal sets turn on near-ties: two fp32
formulations of the same math put a different item among some row's 21
nearest, and that moves the Jaccard distance by ~0.06 (``PERF.md``).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from ..reference.rerank import rerank

ROOT = Path(__file__).resolve().parents[2]
ARTIFACTS = ROOT / "build" / "reid_bench"
FAILED_MS = 3.6e6
ADD_BLOCK = 2048


MODEL_KEYS = ("trunk_layers", "trunk_width", "feat_dim", "siamese_out", "seq_len", "height", "width")
OFF = 1e-4  # a served score this far from the reference's distance is off


def _digest(cfg, p):
    """The artifact's key: the system's sources, the model's sizes, the export batch."""
    h = hashlib.sha256(json.dumps([[cfg[k] for k in MODEL_KEYS], p["model_flags"], p["export_batch"]]).encode())
    for path in sorted((ROOT / "grl_tpu_torch").rglob("*")):
        if path.suffix in (".py", ".cu", ".cpp"):
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def artifact(cfg, p, device):
    """The exported descriptor program's path, exported first if need be."""
    where = ARTIFACTS / _digest(cfg, p)
    model = where / "model.npz"
    if model.exists():
        return model
    where.mkdir(parents=True, exist_ok=True)
    ckpt = where / "checkpoint.npz"
    py = [sys.executable, "-m"]
    subprocess.run(py + ["grl_tpu_torch.tools.make_random_checkpoint", "-o", str(ckpt), "--num-classes",
                         str(cfg["num_train_ids"])] + p["model_flags"], check=True, cwd=ROOT, stdout=sys.stderr)
    tmp = where / "model.tmp.npz"
    subprocess.run(py + ["grl_tpu_torch.cli.extract", "--device", device, "export-model", "--checkpoint", str(ckpt),
                         "--num-classes", str(cfg["num_train_ids"]), "--batch", str(p["export_batch"]),
                         "--seq_len", str(cfg["seq_len"]), "--height", str(cfg["height"]),
                         "--width", str(cfg["width"]), "-o", str(tmp)] + p["model_flags"],
                   check=True, cwd=ROOT, stdout=sys.stderr)
    ckpt.unlink()
    tmp.rename(model)
    return model


def clustered(rng, n, centres, cams, spread):
    """``n`` unit rows around random ``centres`` -> (rows, ids, cameras)."""
    ids = rng.randint(0, centres.shape[0], n)
    d = centres.shape[1]
    rows = centres[ids] + spread * rng.standard_normal((n, d)).astype(np.float32) / np.sqrt(d)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32), ids, rng.randint(0, cams, n)


def schedule(p, seconds, rng):
    """``[(due offset s, queries)]``: one seeded Poisson arrival sequence
    at ``rate`` that fills ``seconds``, the same for every run, and one
    seeded multiset of sizes, in an order from ``rng``. (Arrivals permuted
    by the run's seed made each seed's bursts, and so its p95, its own: two
    runs of one seed agreed within ~6 %, seeds spread 204-267 ms on an
    NVIDIA H100.)"""
    fixed = np.random.RandomState(p["sizes_seed"])
    n_max = int(p["rate"] * seconds * 2) + 16
    gaps = fixed.exponential(1.0 / p["rate"], n_max)
    sizes = fixed.randint(1, p["q_max"] + 1, n_max)
    n = int(np.searchsorted(np.cumsum(gaps), seconds, side="right"))
    return list(zip(np.cumsum(gaps[:n]), sizes[:n][rng.permutation(n)]))


class Session:
    """A daemon with the enrolled gallery, warmed, and its clients."""

    def __init__(self, ctx):
        from grl_tpu_torch.client import ServeClient

        cfg, p = ctx.config, ctx.params
        self.ctx, self.p = ctx, p
        rng = ctx.rng(1)
        centres = rng.standard_normal((cfg["num_test_ids"], 3 * cfg["feat_dim"])).astype(np.float32)
        self.centres = centres / np.linalg.norm(centres, axis=1, keepdims=True)
        self.gallery, ids, cams = clustered(rng, cfg["gallery_size"], self.centres, cfg["num_cams"], p["spread"])
        model = artifact(cfg, p, ctx.device)
        self.sock = os.path.join(tempfile.gettempdir(), f"reid_bench.{os.getpid()}.sock")
        self.address = "unix:" + self.sock
        argv = [sys.executable, "-m", "reid_bench.daemon", "--device", ctx.device, "serve", "--model", str(model),
                "--listen", self.address, "--capacity", str(cfg["gallery_size"]), "--topk", str(p["topk"]),
                "--rerank-queries", str(p["q_max"])]
        self.proc = subprocess.Popen(argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=ROOT)
        try:
            self.admin = self._connect(ServeClient, p["start_timeout"])
            for i in range(0, len(self.gallery), ADD_BLOCK):
                self.admin.add(features=self.gallery[i : i + ADD_BLOCK], pids=ids[i : i + ADD_BLOCK],
                               camids=cams[i : i + ADD_BLOCK])
            self.clients = [self._connect(ServeClient, 60) for _ in range(p["connections"])]
            warm = clustered(ctx.rng(2), p["q_max"], self.centres, cfg["num_cams"], p["spread"])[0]
            for _ in range(p["warm_requests"]):
                self.admin.rank(features=warm, topk=p["topk"], rerank=True)
        except BaseException:
            self.close()
            raise

    def _connect(self, client_cls, timeout):
        deadline = time.time() + timeout
        while True:
            try:
                return client_cls.connect(self.address, timeout=600)
            except (FileNotFoundError, ConnectionRefusedError, socket.timeout):
                if self.proc.poll() is not None or time.time() > deadline:
                    raise RuntimeError(f"the daemon did not listen on {self.address} "
                                       f"(exit code {self.proc.poll()})") from None
                time.sleep(0.2)

    def command(self, line):
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        return self.proc.stdout.readline().strip()

    def window(self, rate, seconds, rng, spans, trace_path=None):
        """One open-loop window; returns ``{"records": [...], ...}``, one
        record per request: ``(due, sent, done, queries, ok, handler ms,
        response)``."""
        from grl_tpu_torch.client import ServeError

        p, cfg = self.p, self.ctx.config
        plan = schedule(dict(p, rate=rate), seconds, rng)
        queries = [clustered(rng, int(q), self.centres, cfg["num_cams"], p["spread"])[0] for _, q in plan]
        todo = queue.Queue()
        records = [None] * len(plan)

        def client_loop(client):
            while (job := todo.get()) is not None:
                i, due = job
                sent = time.time_ns()
                try:
                    resp = client.rank(features=queries[i], topk=p["topk"], rerank=True)
                    ok, ms = True, resp["ms"]
                except ServeError as e:
                    resp, ok, ms = {"error": str(e)}, False, float("nan")
                done = time.time_ns()
                spans.done.append(("rank.request", sent, done))
                records[i] = (due, sent, done, len(queries[i]), ok, ms, resp)

        threads = [threading.Thread(target=client_loop, args=(c,), daemon=True) for c in self.clients]
        for t in threads:
            t.start()
        if trace_path:
            self.command("trace start")
        start = time.time_ns()
        for i, (offset, _) in enumerate(plan):
            due = start + int(offset * 1e9)
            pause = (due - time.time_ns()) / 1e9
            if pause > 0:
                time.sleep(pause)
            todo.put((i, due))
        for _ in threads:
            todo.put(None)
        deadline = time.time() + seconds + 60
        for t in threads:
            t.join(timeout=max(deadline - time.time(), 0))
        end = time.time_ns()
        if trace_path:
            self.command(f"trace stop {trace_path}")
        return {"records": records, "start_ns": start, "end_ns": end, "plan": plan, "queries": queries}

    def peak(self):
        return int(self.command("peak"))

    def modules(self):
        """The daemon's loaded modules of ``run.FORBIDDEN``."""
        return json.loads(self.command("modules"))

    def close(self):
        for c in getattr(self, "clients", []):
            c.close()
        if getattr(self, "admin", None) is not None:
            try:
                self.admin.shutdown()
            except Exception:  # noqa: BLE001 - the daemon may already be gone
                pass
            self.admin.close()
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        if os.path.exists(self.sock):
            os.unlink(self.sock)


def latencies_ms(records):
    """Each request's latency from when it was due (a failed or missing one: ``FAILED_MS``)."""
    return np.array([FAILED_MS if r is None or not r[4] else (r[2] - r[0]) / 1e6 for r in records])


def served(resp, n_q, topk):
    """(indices, scores), each (n_q, topk), of a rank response; an entry
    that it lacks is (-1, nan)."""
    order = np.full((n_q, topk), -1)
    scores = np.full((n_q, topk), np.nan)
    for q, r in enumerate(resp["results"][:n_q]):
        for j, m in enumerate(r["matches"][:topk]):
            order[q, j], scores[q, j] = m["gallery"], m["score"]
    return order, scores


def off_entries(order, dist, ref_dist):
    """``(entries off, entries)`` of a top-k ``order`` (q, k) served at
    distances ``dist`` against the reference's distances (q, g). An entry
    is off where it is missing or out of the gallery, repeats an earlier
    item of its row, lies more than ``OFF`` beyond the row's k-th nearest
    by the reference, or is served more than ``OFF`` from the reference's
    distance of its item."""
    k = order.shape[1]
    valid = (order >= 0) & (order < ref_dist.shape[1])
    at = np.take_along_axis(ref_dist, np.where(valid, order, 0), axis=1)
    kth = np.sort(ref_dist, axis=1)[:, k - 1 : k]
    repeat = ((order[:, :, None] == order[:, None, :]) & np.tri(k, k, -1, dtype=bool)).any(axis=2)
    off = ~valid | repeat | (at > kth + OFF) | ~(np.abs(dist - at) <= OFF)
    return int(off.sum()), int(order.size)


def entry_stats(order, dist, ref_dist):
    """How an answer's top-k (``order``, with its distances ``dist``) sits
    against the reference's distances, entry by entry."""
    at = np.take_along_axis(ref_dist, order, axis=1)
    gap = np.abs(dist - at).ravel()
    best = np.sort(ref_dist, axis=1)[:, : order.shape[1]]
    recall = np.mean([len(set(o) & set(b)) / len(o) for o, b in
                      zip(order, np.argsort(ref_dist, axis=1, kind="stable")[:, : order.shape[1]])])
    return {"max": float(gap.max()), "median": float(np.median(gap)), "p90": float(np.percentile(gap, 90)),
            "over_1e-4": float((gap > 1e-4).mean()), "over_1e-3": float((gap > 1e-3).mean()),
            "rank_gap": float((at - best).max()), "recall": float(recall)}


def run(ctx, control=None):
    """One run (see the module docstring). ``control``: a precision for the
    reference put in the program's place (``reid_bench.control``)."""
    from ..run import Outcome
    from ..trace import Timeline

    cfg, p = ctx.config, ctx.params
    session = Session(ctx)
    try:
        setup_s = time.time() - ctx.t0
        seconds = min(ctx.seconds, p["trace_seconds"]) if ctx.trace else ctx.seconds
        trace_path = (os.path.join(tempfile.gettempdir(), f"reid_bench.{os.getpid()}.trace.json")
                      if ctx.trace else None)
        w = session.window(p["rate"], seconds, ctx.rng(3), ctx.spans, trace_path)
        peak = session.peak()
        forbidden = session.modules()
    finally:
        session.close()
    records = w["records"]
    lat = latencies_ms(records)
    late = np.array([(r[1] - r[0]) / 1e6 for r in records if r is not None])
    print(f"reid_bench: {len(records)} requests at {p['rate']}/s; sent late by ms: p50 "
          f"{np.percentile(late, 50):.3f}, p95 {np.percentile(late, 95):.3f}, max {late.max():.3f}",
          file=sys.stderr)
    answered = [i for i, r in enumerate(records) if r is not None and r[4]]
    failed = len(records) - len(answered)
    timeline = None
    if trace_path:
        with open(trace_path) as f:
            t = json.load(f)
        os.unlink(trace_path)
        timeline = Timeline([tuple(e) for e in t["events"]], t["start_ns"], t["end_ns"])

    # the check: a sample of the answered requests and the largest
    rng = ctx.rng(4)
    picks = list(rng.choice(answered, size=min(p["sample"], len(answered)), replace=False))
    picks.append(max(answered, key=lambda i: records[i][3]))
    dev = ctx.device
    gf = torch.from_numpy(session.gallery).to(dev)
    kw = dict(k1=cfg["rerank_k1"], k2=cfg["rerank_k2"], lambda_value=cfg["rerank_lambda"])
    off = [0, 0]
    control_off = [0, 0]
    looks = {"program": [], "control": [], "fp32": []}
    for i in picks:
        qf = torch.from_numpy(w["queries"][i]).to(dev)
        ref = rerank(qf.double(), gf.double(), **kw).cpu().numpy()
        order, scores = served(records[i][6], len(qf), p["topk"])
        off = [a + b for a, b in zip(off, off_entries(order, -scores, ref))]
        if control is not None:
            looks["program"].append(entry_stats(order, -scores, ref))
            for name, dist in (("control", rerank(qf, gf, precision=control, **kw)), ("fp32", rerank(qf, gf, **kw))):
                dist = dist.cpu().numpy()
                c_order = np.argsort(dist, axis=1, kind="stable")[:, : p["topk"]]
                c_dist = np.take_along_axis(dist, c_order, axis=1)
                looks[name].append(entry_stats(c_order, c_dist, ref))
                if name == "control":
                    control_off = [a + b for a, b in zip(control_off, off_entries(c_order, c_dist, ref))]
    limits = ctx.workload["limits"]
    handler = [r[5] for r in records if r is not None and r[4]]
    transport = [(r[2] - r[1]) / 1e6 - r[5] for r in records if r is not None and r[4]]
    out = Outcome(
        end_to_end={"rank_p95_ms": float(np.percentile(lat, 95))}, setup_s=setup_s,
        attempted=len(records), failed=failed,
        checks={"served_off": (off[0] / off[1], limits["served_off"]), "failed_requests": (failed, 0)},
        memory_peak_bytes=peak, forbidden=forbidden, window_s=(w["end_ns"] - w["start_ns"]) / 1e9,
        counters={"requests": len(answered), "handler_ms": handler, "transport_ms": transport,
                  "live_queries": [records[i][3] for i in answered], "gallery": cfg["gallery_size"],
                  "q_pad": -(-p["q_max"] // p["export_batch"]) * p["export_batch"], "dim": gf.shape[1]},
        device_trace=timeline)
    if control is not None:
        out.control = {"served_off": control_off[0] / control_off[1], "look": looks}
    return out
