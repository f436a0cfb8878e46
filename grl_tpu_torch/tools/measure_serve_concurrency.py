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

    python3 -m grl_tpu_torch.tools.measure_serve_concurrency [--model m.npz]
        [--clients 6] [--reps 8] [--batch 8] [--seq_len 4] [--rank-every 4]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
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
    with tempfile.TemporaryDirectory(prefix="serve_conc_") as tmp:
        report = _run(args, tmp)
    print(json.dumps(report))
    return report


def _run(args, tmp):
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

        total = args.clients * args.reps

        # one connection, `total` one-clip requests in turn
        s0, t0 = snap(), time.time()
        for j in range(total):
            issue(c, j)
        seq = {"wall_s": time.time() - t0, **delta(s0, snap())}

        # `clients` connections x `reps`, started together at a barrier
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
        s0, t0 = snap(), time.time()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        conc = {"wall_s": time.time() - t0, **delta(s0, snap())}
        if any(e is not None for e in errs):
            raise RuntimeError(f"concurrent clients failed: {errs}")
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
