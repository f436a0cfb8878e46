"""Time the evaluation tail at MARS and LS-VID scale (counterpart of
``tools/bench_eval_tail.py``).

The tail is the cosine distance matrix, optionally k-reciprocal
re-ranking (``--rerank``), and the CMC/mAP protocol on the device, over
synthetic L2-normalized features: MARS is 1980 queries against 11310
query ∪ gallery items; ``--lsvid`` is LS-VID's 3000 against 33000 (n =
36000 re-ranked items). The feature upload is outside the timer. It
prints the seconds of each stage (distances, re-ranking and, within it,
the min-plus kernel's slabs; the protocol), rank-1 and mAP, and each
rank's peak device memory, then one JSON line with every number.

``--devices N`` runs the tail on N ranks (one per card, capped at the
visible cards; N gloo ranks with ``--device cpu``): each rank computes its
block of the distances, re-ranking runs row-sharded over the group, and
each rank scores its query rows. ``--from-host`` computes the distance
blocks on the host from the features cut to 64 dimensions (re-ranking's
cost does not depend on the dimension) and uploads them, so the device
holds only the re-ranking's own buffers. ``--warm`` adds a second pass:
grl_tpu's second pass reuses XLA's compiled stage programs, which have no
counterpart here (torch compiles nothing), so the port's second pass
differs from the first only by library and allocator set-up. CPU times
share one host and say nothing of a card.

    python3 -m grl_tpu_torch.tools.bench_eval_tail [--lsvid] [--rerank] [--from-host] \\
        [--dim 6144] [--devices N] [--warm] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# (queries, gallery items besides the queries); the gallery is query ∪ gallery
SIZES = {"MARS": (1980, 9330), "LS-VID": (3000, 30000)}
HOST_DIM = 64


def _unit(rng, rows, dim):
    x = rng.randn(rows, dim).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tail(opts):
    """Every pass of the tail on this process (a rank of the group, or
    alone); returns its numbers."""
    from .. import parallel, resolve_device, set_precision
    from ..engine import metrics
    from ..engine.evaluator import cosine_distance, rerank_columns, rerank_inputs
    from ..engine.rerank import re_ranking
    from ..ops import minplus

    set_precision()
    mesh = parallel.current_mesh()
    device = resolve_device(opts["device"]) if mesh is None else mesh.device
    q, g, dim = opts["q"], opts["g"], opts["dim"]
    rng = np.random.RandomState(0)
    qf = _unit(rng, q, dim)
    gf = np.concatenate([qf, _unit(rng, g, dim)])
    q_pids = rng.randint(0, q, q)
    g_pids = np.concatenate([q_pids, rng.randint(0, q, g)])
    q_cams = rng.randint(0, 6, q)
    g_cams = np.concatenate([q_cams, rng.randint(0, 6, g)])
    if opts["from_host"]:
        qf, gf = (x[:, :HOST_DIM] / np.linalg.norm(x[:, :HOST_DIM], axis=1, keepdims=True) for x in (qf, gf))
    rows = (0, q) if mesh is None else parallel.row_block(q, mesh)[:2]
    cuda = device.type == "cuda"
    slabs = []

    def timed_minplus(a, b):
        if not cuda:
            t0 = time.perf_counter()
            out = minplus(a, b)
            slabs.append((tuple(b.shape), time.perf_counter() - t0))
            return out
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = minplus(a, b)
        end.record()
        slabs.append((tuple(b.shape), start, end))
        return out

    passes = []
    for _ in range(2 if opts["warm"] else 1):
        where = torch.device("cpu") if opts["from_host"] else device
        qf_t, gf_t = torch.from_numpy(qf).to(where), torch.from_numpy(gf).to(where)
        _sync(device)
        slabs.clear()
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        stages = {}
        t0 = time.perf_counter()
        if opts["rerank"]:
            if mesh is None:
                box = rerank_inputs(qf_t, gf_t)
            else:
                box = [rerank_columns(qf_t, gf_t, mesh)]
            box = [m.to(device) for m in box]
            del qf_t, gf_t
            _sync(device)
            stages["distances_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            dist = re_ranking(inputs_box=box, min_sum_fn=timed_minplus, mesh=mesh, query_num=q)
            _sync(device)
            stages["rerank_s"] = time.perf_counter() - t0
            dist = dist[rows[0] : rows[1]]
        else:
            dist = (cosine_distance(qf_t, gf_t) if mesh is None
                    else parallel.sharded_cosine_distance(qf_t, gf_t, mesh)).to(device)
            del qf_t, gf_t
            _sync(device)
            stages["distances_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cmc, mAP = metrics.evaluate_device(dist, q_pids, g_pids, q_cams, g_cams, mesh=mesh)
        stages["protocol_s"] = time.perf_counter() - t0
        del dist
        _sync(device)
        ms = [s[1] * 1e3 if not cuda else s[1].elapsed_time(s[2]) for s in slabs]
        passes.append({"seconds": sum(stages.values()), **stages, "min_sum_ms": sum(ms),
                       "slabs": [list(s[0]) for s in slabs], "slab_ms": ms, "launches": len(slabs),
                       "rank1": float(cmc[0]), "mAP": mAP,
                       "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None})
    return {"rank": 0 if mesh is None else mesh.rank, "device": str(device), "passes": passes}


def main(argv=None):
    from .. import parallel

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lsvid", action="store_true", help="3000 x 33000 instead of MARS's 1980 x 11310")
    ap.add_argument("--rerank", action="store_true")
    ap.add_argument("--warm", action="store_true", help="a second pass (see the module docstring)")
    ap.add_argument("--from-host", action="store_true",
                    help="re-ranking's input distances computed on the host (64-d) and uploaded")
    ap.add_argument("--dim", type=int, default=6144)
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks to run the tail on (one per card; gloo ranks with --device cpu)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    label = "LS-VID" if args.lsvid else "MARS"
    q, g = SIZES[label]
    opts = {"q": q, "g": g, "dim": args.dim, "rerank": args.rerank, "from_host": args.from_host,
            "warm": args.warm, "device": args.device}
    n = parallel.auto_mesh(limit=args.devices, device=args.device)
    if n > 1:
        ranks = parallel.launch(tail, opts, n, args.device)
    else:
        if args.devices > 1:
            print(f"--devices {args.devices}: running on one {args.device} device "
                  f"({parallel.visible_devices(args.device)} visible)")
        ranks = [tail(opts)]
    what = f"{label} eval tail ({q}x{q + g}){' +rerank' if args.rerank else ''}" + (
        " from host distances" if args.from_host else "")
    for i, p in enumerate(ranks[0]["passes"]):
        peaks = ", ".join(f"{r['passes'][i]['peak_gib']:.2f}" if r["passes"][i]["peak_gib"] is not None
                          else "not measured" for r in ranks)
        rerank = (f", re-ranking {p['rerank_s']:.3f} of which min-sum {p['min_sum_ms'] / 1e3:.3f} in "
                  f"{p['launches']} slab(s)" if args.rerank else "")
        print(f"{what}, pass {i + 1} on {n} rank(s): {p['seconds']:.3f} s = {q / p['seconds']:.0f} queries/s "
              f"(distances {p['distances_s']:.3f}{rerank}, protocol {p['protocol_s']:.3f}); "
              f"rank1={p['rank1']:.3f} mAP={p['mAP']:.3f}; peak GiB by rank: {peaks}", flush=True)
    print(json.dumps({"tail": label, "queries": q, "gallery": q + g, "n": 2 * q + g, "dim": args.dim,
                      "rerank": args.rerank, "from_host": args.from_host, "ranks": ranks}))
    return ranks


if __name__ == "__main__":
    main()
