"""Measure the serve daemon's cross-request describe coalescing
(counterpart of ``tools/measure_serve_concurrency.py``).

The daemon packs concurrent connections' clips into shared dispatches of
the artifact's batch width (``cli/extract.py::_DescribeCoalescer``). This
drives a daemon in this process (``serve --listen unix:``, in a thread)
with the same total number of one-clip ``describe`` requests twice: one
after another from one connection, then from ``--clients`` concurrent
connections. It prints one JSON line: the wall times and the daemon's own
``describe_batching`` counters (``stats``) for each.

``--rank-every K`` makes every Kth request of each client a ``rank``
(clips -> descriptor -> gallery top-k) against a small random index;
rank's descriptor rides the same coalescer. Without ``--model`` it builds
a tiny random-init artifact (``make_random_checkpoint --tiny``, then
``export-model``). It runs on the card by default; ``--device cpu`` runs
on the host.

Then it runs both phases again with the coalescer timed from the outside
(its methods wrapped in this process; the daemon's code is unchanged) and
adds that pass to each phase as its ``timeline``: the pass's own wall and
counters (the headline numbers above come from the pass without the
probe), the dispatches' seconds (the artifact call:
upload, program, the copy back that waits for the card) and the leading
thread's CPU seconds in them (``time.thread_time``: what it ran, not what
it waited for), the leads' (one FIFO drain and its call), the gaps
between one lead's end and the next one's start, each request's wait from
its arrival to the lead that took it, its hand-off (from the end of the
lead that carried its rows to its return) and, per connection, the
turnaround from one request's return to the next one's arrival (response,
client, transport, request).

    python3 -m grl_tpu_torch.tools.measure_serve_concurrency [--model m.npz]
        [--clients 6] [--reps 8] [--batch 8] [--seq_len 4] [--rank-every 4]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import statistics
import tempfile
import threading
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", type=str, default="", help="exported artifact; omit to build a tiny one")
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--reps", type=int, default=8, help="one-clip describes per concurrent client")
    ap.add_argument("--batch", type=int, default=8, help="artifact batch width (tiny build only)")
    ap.add_argument("--seq_len", type=int, default=4)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--width", type=int, default=32)
    ap.add_argument("--rank-every", type=int, default=0,
                    help="make every Kth request per client a rank (0 = describe only)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the daemon (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="serve_conc_") as tmp, Timeline() as tl:
        report = _run(args, tmp, tl)
    print(json.dumps(report))
    return report


class Timeline:
    """Wraps ``_DescribeCoalescer``'s ``__init__`` (its artifact call),
    ``describe`` and ``_lead`` while it is entered; while ``on``, the
    wrappers record ``time.perf_counter()`` marks, and ``summary()`` reads
    the marks since the last ``reset()``. The probe takes none of the
    coalescer's locks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._saved = {}
        self.on = False
        self.reset()

    def reset(self):
        with self._lock:
            self.calls, self.leads, self.requests = [], [], []

    def __enter__(self):
        from ..cli import extract

        cls = extract._DescribeCoalescer
        self._saved = {name: getattr(cls, name) for name in ("__init__", "describe", "_lead")}
        init, describe, lead = (self._saved[k] for k in ("__init__", "describe", "_lead"))
        tl = self

        def timed_call(call):
            def run(chunk):
                if not tl.on:
                    return call(chunk)
                t0, c0 = time.perf_counter(), time.thread_time()
                try:
                    return call(chunk)
                finally:
                    with tl._lock:
                        tl.calls.append((t0, time.perf_counter(), time.thread_time() - c0))
            return run

        def init_(self, call, batch):
            init(self, timed_call(call), batch)

        def describe_(self, clips):
            if not tl.on:
                return describe(self, clips)
            rec = {"thread": threading.get_ident(), "enter": time.perf_counter(), "clips": clips}
            with tl._lock:
                tl.requests.append(rec)
            try:
                return describe(self, clips)
            finally:
                rec["exit"] = time.perf_counter()

        def lead_(self):
            if not tl.on:
                return lead(self)
            # list() of the queue is one C call under the GIL: a consistent
            # snapshot without the coalescer's lock, which its waiters sleep on
            queued = list(self._q)
            t0 = time.perf_counter()
            lead(self)
            t1 = time.perf_counter()
            left = {id(item) for item in list(self._q)}
            taken = [item["clips"] for item in queued if id(item) not in left]
            with tl._lock:
                if taken:
                    tl.leads.append({"start": t0, "end": t1, "clips": taken})

        cls.__init__, cls.describe, cls._lead = init_, describe_, lead_
        return self

    def __exit__(self, *exc):
        from ..cli import extract

        for name, fn in self._saved.items():
            setattr(extract._DescribeCoalescer, name, fn)

    def summary(self):
        """Seconds (and counts) of the marks since the last ``reset``."""
        import numpy as np

        with self._lock:
            calls, leads, requests = list(self.calls), list(self.leads), list(self.requests)
        leads.sort(key=lambda d: d["start"])
        stats = lambda xs: ({"n": len(xs), "mean": statistics.fmean(xs), "median": statistics.median(xs),
                             "max": max(xs), "sum": sum(xs)} if xs else {"n": 0})
        waits, handoffs = [], []
        for rec in requests:
            # the leads that carried this request's rows (its chunks are views of its clips)
            mine = [d for d in leads if any(np.may_share_memory(c, rec["clips"]) for c in d["clips"])]
            if mine and "exit" in rec:
                waits.append(min(d["start"] for d in mine) - rec["enter"])
                handoffs.append(rec["exit"] - max(d["end"] for d in mine))
        turnaround = []
        by_thread = {}
        for rec in sorted(requests, key=lambda r: r["enter"]):
            by_thread.setdefault(rec["thread"], []).append(rec)
        for recs in by_thread.values():
            turnaround += [b["enter"] - a["exit"] for a, b in zip(recs, recs[1:]) if "exit" in a]
        gaps = [b["start"] - a["end"] for a, b in zip(leads, leads[1:])]
        return {"dispatch_s": stats([b - a for a, b, _ in calls]), "dispatch_cpu_s": stats([c for _, _, c in calls]),
                "lead_s": stats([d["end"] - d["start"] for d in leads]),
                "gap_s": stats(gaps), "wait_s": stats(waits), "handoff_s": stats(handoffs),
                "turnaround_s": stats(turnaround)}


def _run(args, tmp, tl):
    import numpy as np

    from ..cli.extract import build_parser, serve
    from ..cli.extract import main as extract_main
    from ..client import ServeClient
    from .make_random_checkpoint import write_random_checkpoint

    model = args.model
    if not model:
        ckpt = write_random_checkpoint(osp.join(tmp, "ckpt.npz"), num_classes=4, tiny=True)
        model = osp.join(tmp, "model.npz")
        extract_main(build_parser().parse_args([
            "--device", args.device, "export-model", "--checkpoint", ckpt, "--tiny", "--num-classes", "4",
            "--batch", str(args.batch), "--seq_len", str(args.seq_len), "--height", str(args.height),
            "--width", str(args.width), "-o", model,
        ]))

    sock = osp.join(tmp, "serve.sock")
    argv = ["--device", args.device, "serve", "--model", model, "--listen", f"unix:{sock}", "--warmup"]
    if args.rank_every:
        argv += ["--capacity", "64", "--topk", "4"]
    daemon = threading.Thread(target=serve, args=(build_parser().parse_args(argv),), daemon=True)
    daemon.start()
    deadline = time.time() + 1200
    while not osp.exists(sock):
        if not daemon.is_alive() or time.time() > deadline:
            raise RuntimeError("the serve daemon did not come up")
        time.sleep(0.1)

    with ServeClient.connect(f"unix:{sock}", timeout=1200) as c:
        meta = c.ping()
        shape = (1, meta["seq_len"], meta["height"], meta["width"], meta["channels"])
        rng = np.random.RandomState(0)
        clip = rng.randint(0, 256, shape, np.uint8)
        d0 = c.describe(clip)  # any first-call cost lands before the timing
        if args.rank_every:
            # a small random index for rank to score against
            c.add(features=rng.randn(32, d0["features"].shape[-1]).astype(np.float32))
            c.rank(clip)

        def issue(conn, j):
            if args.rank_every and (j + 1) % args.rank_every == 0:
                conn.rank(clip)
            else:
                conn.describe(clip)

        def snap():
            return c.stats()["describe_batching"]

        def delta(a, b):
            return {k: b[k] - a[k] for k in a}

        def phase(s0, t0):
            return {"wall_s": time.time() - t0, **delta(s0, snap()), **(tl.summary() if tl.on else {})}

        total = args.clients * args.reps

        def phases():
            """`total` one-clip requests in turn on one connection, then from
            `clients` connections x `reps` started together at a barrier."""
            s0 = snap()
            tl.reset()
            t0 = time.time()
            for j in range(total):
                issue(c, j)
            seq = phase(s0, t0)

            barrier = threading.Barrier(args.clients)
            errs = [None] * args.clients

            def worker(i):
                try:
                    with ServeClient.connect(f"unix:{sock}", timeout=1200) as w:
                        barrier.wait()
                        for j in range(args.reps):
                            issue(w, j)
                except Exception as e:  # noqa: BLE001
                    errs[i] = e
                    barrier.abort()  # the peers waiting at the barrier see it too

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(args.clients)]
            s0 = snap()
            tl.reset()
            t0 = time.time()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            conc = phase(s0, t0)
            if any(e is not None for e in errs):
                raise RuntimeError(f"concurrent clients failed: {errs}")
            return seq, conc

        seq, conc = phases()
        tl.on = True
        for ph, probed in zip((seq, conc), phases()):
            ph["timeline"] = probed
        tl.on = False
        c.shutdown()
    daemon.join(timeout=60)

    for ph in (seq, conc):
        ph["clips_per_dispatch"] = ph["clips"] / max(ph["dispatches"], 1)
    return {
        "device": args.device, "batch": meta["batch"], "total_clips": total, "clients": args.clients,
        "rank_every": args.rank_every, "sequential": seq, "concurrent": conc,
        "dispatch_reduction": seq["dispatches"] / max(conc["dispatches"], 1),
        "speedup": seq["wall_s"] / max(conc["wall_s"], 1e-9),
    }


if __name__ == "__main__":
    main()
