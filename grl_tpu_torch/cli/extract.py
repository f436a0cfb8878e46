"""Descriptor extraction + retrieval, the deployment surface (counterpart of
``grl_tpu/cli/extract.py``).

    # a gallery index and a query set from a dataset split
    python -m grl_tpu_torch.cli.extract features -d mars --data-dir ... \\
        --logs-dir log/grl --split gallery -o gallery.npz
    python -m grl_tpu_torch.cli.extract features ... --split query -o query.npz

    # rank queries against the index (optionally k-reciprocal re-ranked)
    python -m grl_tpu_torch.cli.extract rank --query query.npz \\
        --gallery gallery.npz --topk 10 -o ranks.json

    # the self-contained descriptor program, one-shot description, the daemon
    python -m grl_tpu_torch.cli.extract export-model --checkpoint ... -o model.npz
    python -m grl_tpu_torch.cli.extract describe --model model.npz --clips c.npz -o f.npz
    python -m grl_tpu_torch.cli.extract serve --model model.npz --gallery gallery.npz

The subcommands and their flags are grl_tpu's, plus ``--device`` (default
``cuda``; ``cpu`` runs on the host) before the subcommand. The serve
daemon speaks grl_tpu's JSON-lines protocol, so ``grl_tpu.client`` and
``grl_tpu_torch.client`` both drive it. ``export-model`` writes a
``torch.export`` program (uint8 clips -> descriptors, weights inside) for
the device it runs on; ``describe`` and ``serve`` load it with no model
code. Every re-ranked answer ends in the min-plus kernel on the card.
``main`` runs in fp32 with TF32 off; ``features --bf16`` and
``export-model --bf16`` compute in bfloat16 (descriptors stay fp32), and a
bf16 artifact is described and served as an fp32 one. ``features
--use-flow`` reads 6-channel RGB|flow clips (iLIDS-VID, PRID-2011), and
``export-model --use-flow`` exports the program for them (``"channels": 6``
in its meta), which ``describe`` and ``serve`` then take and which refuse
3-channel clips. ``features --devices N`` (default 0: every visible card)
describes the split on one rank per card (N gloo ranks under ``--device
cpu``), each its stripe, and rank 0 writes the assembled rows in catalog
order. ``serve --devices`` above 1 (grl_tpu row-shards the re-ranking)
is not ported yet and exits naming ROADMAP queue A, item 7.

``rank`` does NOT prepend queries to the gallery and does not junk-filter:
it is retrieval, not CMC.
"""

from __future__ import annotations

import argparse
import functools
import io
import json
import os
import os.path as osp

import numpy as np
import torch

from .. import parallel, resolve_device, set_precision
from ..config import ExperimentConfig
from ..data import get_data
from ..engine import Evaluator, init_train_state
from ..engine.evaluator import _euclidean, cosine_distance, make_descriptor_fn
from ..engine.rerank import re_ranking, re_ranking_padded, top_k, warn_if_degenerate
from ..utils import load_train_state
from .train import _not_ported, _synthetic_kwargs, build_models, eval_meta, ranks_to_launch, say_one_device

# serve's rerank takes the one-program capacity-padded builder up to this
# many total items (padded queries + capacity + enrollment block), the staged
# memory-lean builder past it. grl_tpu's cut; module-level so tests can
# shrink it to drive the staged route at toy n.
_RERANK_ONEJIT_MAX = 16384
# torch.export.save writes a zip archive; jax.export blobs are flatbuffers
_ZIP_MAGIC = b"PK\x03\x04"


def _reject_unported(args):
    """What the port does not have yet exits naming its ROADMAP item:
    ``serve --devices`` above 1 (grl_tpu row-shards the re-ranking)."""
    if args.command == "serve" and getattr(args, "devices", 1) > 1:
        _not_ported("--devices above 1", 7, "row-sharded re-ranking over several cards")


def _load_models(args, num_classes, device):
    """The models of ``args``' architecture with the checkpoint's weights on
    ``device``; returns ``(cnn, siamese)``."""
    cnn, siamese, siamese_uncorr = build_models(args, tiny=args.tiny)
    state = init_train_state(cnn, siamese, siamese_uncorr, num_classes, num_feat=cnn.num_feat,
                             device=device)
    ckpt = args.checkpoint or osp.join(args.logs_dir, "checkpoint_best.npz")
    load_train_state(state, ckpt)
    print(f"loaded {ckpt}")
    return cnn.eval(), siamese.eval()


def extract_split(args):
    mesh = parallel.maybe_initialize_distributed(args.device)
    if mesh is None and (n := ranks_to_launch(args)) > 1:
        return parallel.launch(main, args, n, args.device)[0]
    device = resolve_device(args.device) if mesh is None else mesh.device
    if mesh is None:
        say_one_device(args)
    dataset, num_classes, _train, query_loader, gallery_loader = get_data(
        args.dataset, args.data_dir,
        # train loaders are unused here, but get_data validates the train
        # batch when only_eval=False (--rrs): any even value satisfies it
        2, args.seq_len, args.seq_srd, args.workers,
        only_eval=not args.rrs, split_id=args.split_id, dataset_kwargs=_synthetic_kwargs(args),
        use_flow=bool(args.use_flow), eval_stripe=mesh is not None,
    )
    loader = {"query": query_loader, "gallery": gallery_loader}[args.split]
    cnn, siamese = _load_models(args, num_classes, device)
    evaluator = Evaluator(cnn, siamese, micro_batch=args.micro_batch, device=device)
    feats, pids, camids = evaluator.extract_features(loader)
    if mesh is not None:
        # each rank described its stripe; the rows assemble in catalog order
        n_total, pids, camids = eval_meta(dataset)[args.split]
        feats = parallel.gather_striped_rows(feats, n_total, mesh)
    feats = feats.cpu().numpy().astype(np.float32)
    if mesh is None or mesh.rank == 0:
        np.savez(args.out, features=feats, pids=pids, camids=camids)
        print(f"wrote {feats.shape[0]} x {feats.shape[1]} descriptors to {args.out}")
    return feats.shape


@torch.inference_mode()
def rank(args):
    device = resolve_device(args.device)
    q = np.load(args.query)
    g = np.load(args.gallery)
    qf = torch.from_numpy(np.asarray(q["features"], np.float32)).to(device)
    gf = torch.from_numpy(np.asarray(g["features"], np.float32)).to(device)
    distmat = cosine_distance(qf, gf)
    if args.rerank:
        warn_if_degenerate(qf.shape[0] + gf.shape[0])
        # boxed hand-over, as the Evaluator: the staged builder (above
        # n = 16384) frees the three distance matrices after its first stage
        box = [distmat, _euclidean(qf, qf), _euclidean(gf, gf)]
        distmat = None
        distmat = re_ranking(inputs_box=box)
    distmat = distmat.cpu().numpy()
    topk = min(args.topk, gf.shape[0])
    order = np.argsort(distmat, axis=1)[:, :topk]
    results = [
        {
            "query": i,
            "query_pid": int(q["pids"][i]),
            "matches": [
                {
                    "gallery": int(j),
                    "pid": int(g["pids"][j]),
                    "camid": int(g["camids"][j]),
                    # similarity = negative distance. Without --rerank: the
                    # dot of the 6144-d descriptor (3 L2-normed blocks ->
                    # range [-3, 3]). With --rerank: the blended
                    # Jaccard/original scale, ordinal only.
                    "score": float(-distmat[i, j]),
                }
                for j in order[i]
            ],
        }
        for i in range(order.shape[0])
    ]
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote top-{topk} rankings for {order.shape[0]} queries to {args.out}")
    return results


class _DescriptorProgram(torch.nn.Module):
    """uint8 clips (b, t, h, w, c) -> descriptors: ``make_descriptor_fn`` as
    one module, for ``torch.export`` (normalization inside)."""

    def __init__(self, cnn, siamese):
        super().__init__()
        self.cnn, self.siamese = cnn, siamese

    def forward(self, clips_u8):
        return make_descriptor_fn(self.cnn, self.siamese)(clips_u8)


def export_model(args):
    """Serialize the descriptor program as a self-contained artifact.

    ``torch.export`` captures uint8 clips -> 6144-d descriptors with the
    checkpoint's weights inside, at the fixed ``--batch`` and clip shape, on
    ``--device``. ``describe`` and ``serve`` load it with ``torch.export.load``
    and no model code. The npz holds the program's bytes under ``exported``
    and grl_tpu's ``meta`` keys; ``platforms`` is the device it was exported
    on. ``describe`` pads the final chunk to the batch."""
    device = resolve_device(args.device)
    platforms = [p.strip() for p in args.platforms.split(",") if p.strip()]
    if platforms and platforms != [device.type]:
        raise SystemExit(f"--platforms {args.platforms}: a torch.export program runs on the device it "
                         f"was exported on; export on each with --device (this run: {device.type})")
    cnn, siamese = _load_models(args, args.num_classes, device)
    channels = 6 if args.use_flow else 3
    example = torch.zeros((args.batch, args.seq_len, args.height, args.width, channels),
                          dtype=torch.uint8, device=device)
    program = torch.export.export(_DescriptorProgram(cnn, siamese).eval(), (example,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    meta = {
        "batch": args.batch, "seq_len": args.seq_len, "height": args.height,
        "width": args.width, "channels": channels,
        "platforms": [device.type], "dim": int(3 * cnn.num_feat),
    }
    np.savez(args.out, exported=np.frombuffer(blob, np.uint8), meta=json.dumps(meta))
    print(f"exported descriptor program ({len(blob) / 1e6:.1f} MB, platforms "
          f"{meta['platforms']}, batch {args.batch}) to {args.out}")
    return meta


def _load_artifact(path, device):
    """Load an ``export-model`` artifact -> ``(call, meta)``. ``call`` takes a
    uint8 numpy chunk of the export batch and returns float32 numpy
    descriptors, computed on ``device`` under ``torch.inference_mode``.
    Refuses, at load, an artifact exported for another device and one that
    ``jax.export`` wrote (grl_tpu's)."""
    device = torch.device(device)
    with np.load(path, allow_pickle=False) as z:
        blob = z["exported"].tobytes()
        meta = json.loads(str(z["meta"]))
    if not blob.startswith(_ZIP_MAGIC):
        raise SystemExit(
            f"{path} is not a torch.export program: it was written by grl_tpu's "
            "export-model (jax.export), which grl_tpu reads (python -m grl_tpu.cli.extract "
            "describe/serve); re-export it with python -m grl_tpu_torch.cli.extract export-model"
        )
    platforms = meta.get("platforms")
    if platforms and device.type not in platforms:
        raise SystemExit(
            f"{path} was exported for {platforms} but this process runs on '{device.type}' — "
            f"re-export with --device {device.type}"
        )
    program = torch.export.load(io.BytesIO(blob)).module()

    def call(chunk):
        with torch.inference_mode():
            clips = torch.from_numpy(np.ascontiguousarray(chunk)).to(device)
            return program(clips).to(torch.float32).cpu().numpy()

    return call, meta


def _check_clips(clips, meta):
    expect = (meta["seq_len"], meta["height"], meta["width"], meta["channels"])
    if clips.shape[1:] != expect:
        raise ValueError(
            f"clips shaped {clips.shape[1:]} but the artifact was exported "
            f"for {expect} (seq_len, height, width, channels)"
        )
    if clips.dtype != np.uint8:
        raise ValueError(
            f"clips dtype {clips.dtype} but the artifact expects uint8 raw "
            "frames (normalization happens inside the exported program)"
        )
    if clips.shape[0] == 0:
        raise ValueError("clips array is empty (0 clips)")


def _artifact_chunks(clips, batch):
    """Yield (chunk padded to the export batch, valid row count)."""
    for i in range(0, clips.shape[0], batch):
        chunk = clips[i : i + batch]
        size = chunk.shape[0]
        if size < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - size,) + chunk.shape[1:], chunk.dtype)]
            )
        yield chunk, size


class _DescribeCoalescer:
    """Cross-request descriptor batching for the serve daemon.

    Concurrent connections' clips pack into shared device dispatches of
    the artifact's batch width, with no timers and no background thread:
    whichever waiter takes the device lock first leads a dispatch, draining
    queued work FIFO up to the batch width; everyone else either sees their
    rows arrive or leads the next dispatch. A lone request therefore
    dispatches immediately with exactly the sequential path's chunking and
    padding (bit-identical results, no added latency when idle); under
    concurrent load, small requests share batches instead of each paying a
    padded dispatch.
    """

    def __init__(self, call, batch):
        import threading

        self._call, self._batch = call, batch
        self._q = []
        self._qlock = threading.Lock()
        self._device = threading.Lock()
        # observability (reported by the daemon's stats op)
        self.dispatches = 0   # device calls issued
        self.clips = 0        # valid clips described
        self.packed = 0       # dispatches carrying >1 waiter's clips

    def describe(self, clips):
        """(n, S, H, W, C) uint8 -> (n, dim) float32 descriptors."""
        import threading

        items = [
            {"clips": clips[i : i + self._batch],
             "done": threading.Event(), "out": None, "err": None}
            for i in range(0, clips.shape[0], self._batch)
        ]
        with self._qlock:
            self._q.extend(items)
        for item in items:
            while not item["done"].is_set():
                # lead a dispatch (of the FIFO head, not necessarily of
                # this item) or wait for one to finish
                if self._device.acquire(timeout=0.05):
                    try:
                        if not item["done"].is_set():
                            self._lead()
                    finally:
                        self._device.release()
        for item in items:
            if item["err"] is not None:
                raise item["err"]
        return np.concatenate([item["out"] for item in items])

    def _lead(self):
        """One dispatch: drain the FIFO head up to the batch width.
        Caller holds the device lock."""
        with self._qlock:
            take, used = [], 0
            while self._q and used + self._q[0]["clips"].shape[0] <= self._batch:
                item = self._q.pop(0)
                take.append(item)
                used += item["clips"].shape[0]
        if not take:
            return
        chunk = np.concatenate(
            [item["clips"] for item in take]
            + ([np.zeros((self._batch - used,) + take[0]["clips"].shape[1:],
                         take[0]["clips"].dtype)]
               if used < self._batch else [])
        )
        try:
            feats = np.asarray(self._call(chunk)).astype(np.float32)
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for item in take:
                item["err"] = e
                item["done"].set()
            return
        off = 0
        for item in take:
            k = item["clips"].shape[0]
            item["out"] = feats[off : off + k]
            off += k
        with self._qlock:
            self.dispatches += 1
            self.clips += used
            self.packed += len(take) > 1
        for item in take:
            item["done"].set()

    def snapshot(self):
        """Packing counters for the daemon's stats op."""
        with self._qlock:
            return {"dispatches": self.dispatches, "clips": self.clips,
                    "packed": self.packed}


def _load_npz_any(spec):
    """An npz operand in a daemon request: a filesystem path string (the
    shared-filesystem handoff) or an inline payload ``{"npz_b64": <base64
    of the npz file bytes>}`` for socket clients on other machines."""
    if isinstance(spec, dict):
        if "npz_b64" not in spec:
            raise ValueError(
                "inline npz operand must be {'npz_b64': <base64 bytes>}, "
                f"got keys {sorted(spec)}"
            )
        import base64

        raw = base64.b64decode(spec["npz_b64"], validate=True)
        return np.load(io.BytesIO(raw))
    return np.load(spec)


def _npz_b64(payload):
    """Arrays -> base64 of the npz file bytes (inline response body)."""
    import base64

    buf = io.BytesIO()
    np.savez(buf, **payload)
    return base64.b64encode(buf.getvalue()).decode("ascii")


def _describe_chunked(call, meta, clips):
    """Sequential describe: clips -> (n, dim) float32 via fixed-width
    padded chunks of the artifact's batch."""
    return np.concatenate(
        [np.asarray(call(chunk))[:size]
         for chunk, size in _artifact_chunks(clips, meta["batch"])]
    ).astype(np.float32)


def _describe_payload(describe_fn, meta, clips_src):
    """Clips npz (``clips`` (n, S, h, w, c) uint8, optional ``pids``/
    ``camids`` passthrough) -> descriptor payload dict. Used by the one-shot
    ``describe`` subcommand and the daemon's describe op alike;
    ``describe_fn`` is the sequential chunked path or the daemon's
    coalescer (identical chunking when uncontended)."""
    src = _load_npz_any(clips_src)
    clips = src["clips"]
    _check_clips(clips, meta)
    payload = {"features": describe_fn(clips)}
    for k in ("pids", "camids"):
        if k in src.files:
            payload[k] = src[k]
    return payload


def describe_with_export(args):
    """Run clips through an ``export-model`` artifact -> descriptor npz."""
    call, meta = _load_artifact(args.model, resolve_device(args.device))
    try:
        payload = _describe_payload(functools.partial(_describe_chunked, call, meta), meta, args.clips)
    except ValueError as e:
        raise SystemExit(str(e))
    np.savez(args.out, **payload)
    feats = payload["features"]
    print(f"wrote {feats.shape[0]} x {feats.shape[1]} descriptors to {args.out}")
    return feats.shape


def serve(args, inp=None, out=None):
    """Persistent descriptor/retrieval daemon over an ``export-model``
    artifact (grl_tpu's ``serve``, same protocol and response keys).

    It loads the program once, then answers JSON-lines requests, one per
    line, one response per line (logs go to stderr), over stdin/stdout or,
    with ``--listen``, over a TCP or ``unix:`` socket with one thread per
    connection. Ops:

      {"op": "ping"}
      {"op": "stats"}                                   # per-op counters
      {"op": "describe", "clips": "in.npz", "out": "feats.npz"}
      {"op": "rank", "clips": "in.npz", "topk": 5}      # needs an index
      {"op": "rank", "clips": "in.npz", "rerank": true} # k-reciprocal
      {"op": "add", "clips": "new.npz"}                 # or "features"
      {"op": "save", "out": "index.npz"}
      {"op": "shutdown"}

    npz operands are paths or inline ``{"npz_b64": ...}`` payloads;
    ``describe``/``save`` answer inline when ``out`` is omitted. ``rank``
    takes raw ``clips`` or precomputed ``features``. Clip description runs
    through a coalescer that packs concurrent requests into shared
    dispatches; index reads and writes and the similarity and re-ranking
    work serialize on one lock.

    The index lives on the device in a buffer of ``--capacity`` + 256 rows
    (zeros past the valid count, masked out of every ranking); ``add``
    enrolls rows in blocks of 256. A re-ranked rank pads the queries to
    ``--rerank-queries`` (rounded up to the batch) and re-ranks against the
    whole buffer with the valid counts: through ``re_ranking_padded`` up to
    ``_RERANK_ONEJIT_MAX`` total items, through the staged builder with
    ``valid`` above it; both end in the min-plus kernel on the card.

    A malformed request gets ``{"ok": false, "error": ...}`` and the loop
    goes on; request lines are capped at ``--max-request-mb`` (an oversize
    line is drained in 1 MiB chunks and answered with an error); every
    response carries ``ms``. SIGTERM/SIGINT finish the in-flight request,
    close the socket, unlink a unix socket file and return.
    """
    import signal
    import socket as socklib
    import sys
    import threading
    import time

    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    _reject_unported(args)
    device = resolve_device(args.device)

    call, meta = _load_artifact(args.model, device)
    # every clip-describe site (describe/add/rank) funnels through the
    # coalescer: concurrent connections' clips share device dispatches
    coalescer = _DescribeCoalescer(call, meta["batch"])
    idx = None
    rerank_unavailable, q_pad = "rank needs serve --gallery or --capacity", 0
    rr_staged = False
    k_max = 0
    ADD_BLOCK = 256  # fixed enrollment granularity
    if args.gallery or args.capacity:
        if args.topk < 1:
            raise SystemExit("serve --topk must be >= 1 (the top-k width of every answer)")
        if args.capacity < 0:
            raise SystemExit("serve --capacity must be >= 0")
        if args.gallery:
            g = np.load(args.gallery)
            feats = g["features"]
            if feats.ndim != 2 or feats.shape[1] != meta["dim"]:
                raise SystemExit(
                    f"gallery features are shaped {feats.shape} but the "
                    f"artifact produces {meta['dim']}-d descriptors"
                )
            if feats.shape[0] == 0 and not args.capacity:
                raise SystemExit(f"gallery index {args.gallery} is empty")
            # an unlabeled index still ranks (labels report as -1)
            labels = {
                k: (np.asarray(g[k]) if k in g.files
                    else np.full(feats.shape[0], -1, np.int64))
                for k in ("pids", "camids")
            }
        else:  # enroll-from-scratch index
            feats = np.zeros((0, meta["dim"]), np.float32)
            labels = {k: np.zeros(0, np.int64) for k in ("pids", "camids")}
        n0 = feats.shape[0]
        capacity = max(args.capacity, n0)
        # one spare ADD_BLOCK, so a fixed-width enrollment block never runs
        # past the buffer
        buf = torch.zeros((capacity + ADD_BLOCK, meta["dim"]), dtype=torch.float32, device=device)
        buf[:n0] = torch.from_numpy(np.asarray(feats, np.float32))
        idx = {"n": n0, "capacity": capacity, "gf": buf,
               "pids": labels["pids"], "camids": labels["camids"]}
        k_max = min(args.topk, capacity)  # capacity >= 1 here
        if args.rerank_queries < 1:
            raise SystemExit("serve --rerank-queries must be >= 1")
        # the rerank geometry is fixed at startup: queries pad to a fixed
        # width, the index to its buffer
        q_pad = meta["batch"] * -(-args.rerank_queries // meta["batch"])
        rerank_unavailable = None
        rr_staged = q_pad + buf.shape[0] > _RERANK_ONEJIT_MAX

    def rank_topk_feats(qf, n_valid):
        # scores: cosine similarity (the rank subcommand's negative-distance
        # convention); rows past the valid count are masked to -inf (the
        # zero rows' similarity 0 would beat genuinely negative matches)
        sim = qf @ idx["gf"].T
        cols = torch.arange(sim.shape[1], device=device)[None, :]
        return top_k(torch.where(cols < n_valid, sim, -torch.inf), k_max)

    def rerank_topk(dist, n_valid):
        # top-k of the re-ranked distances with the padding columns masked
        # out; scores are -distance (ordinal only, like `rank --rerank`)
        cols = torch.arange(dist.shape[1], device=device)[None, :]
        return top_k(torch.where(cols < n_valid, -dist, -torch.inf), k_max)

    def enroll(feats, pids, camids):
        """Append descriptor rows to the device-resident index."""
        n, n_add = idx["n"], feats.shape[0]
        if n + n_add > idx["capacity"]:
            raise ValueError(
                f"index at {n}/{idx['capacity']}: adding {n_add} exceeds "
                "capacity — restart serve with a larger --capacity"
            )
        for i in range(0, n_add, ADD_BLOCK):
            block = feats[i : i + ADD_BLOCK]
            if block.shape[0] < ADD_BLOCK:  # zero-pad: rows past the new
                block = np.concatenate(    # count stay masked out of rank
                    [block, np.zeros((ADD_BLOCK - block.shape[0], block.shape[1]), np.float32)]
                )
            idx["gf"][n + i : n + i + ADD_BLOCK] = torch.from_numpy(block).to(device)
        idx["n"] = n + n_add
        idx["pids"] = np.concatenate([idx["pids"], pids])
        idx["camids"] = np.concatenate([idx["camids"], camids])

    def load_add_features(req):
        """An add request carries either descriptors or raw clips."""
        src = _load_npz_any(req["features"] if "features" in req else req["clips"])
        if "features" in req:
            feats = np.asarray(src["features"], np.float32)
            if feats.ndim != 2 or feats.shape[1] != meta["dim"]:
                raise ValueError(f"add features shaped {feats.shape}, need (n, {meta['dim']})")
        else:
            clips = src["clips"]
            _check_clips(clips, meta)
            feats = coalescer.describe(clips)
        labels = {}
        for k in ("pids", "camids"):
            labels[k] = (np.asarray(src[k], np.int64) if k in src.files
                         else np.full(feats.shape[0], -1, np.int64))
            if labels[k].shape != (feats.shape[0],):
                raise ValueError(f"{k} shaped {labels[k].shape}, need ({feats.shape[0]},)")
        return feats, labels["pids"], labels["camids"]

    def matches_of(order_row, scores_row, topk):
        return [
            {"gallery": int(j), "pid": int(idx["pids"][j]),
             "camid": int(idx["camids"][j]), "score": float(s)}
            for j, s in zip(order_row[:topk], scores_row[:topk])
        ]

    def rerank_dist(qf, n_q):
        """(q_pad, dim) padded query features -> (q_pad, G) re-ranked
        distances; rows past n_q and columns past idx["n"] are garbage.
        The one-program padded builder below _RERANK_ONEJIT_MAX total items,
        the staged builder (same padding convention) above it."""
        n = idx["n"]
        if rr_staged:
            # gg is not cached on this route: the staged builder frees the
            # distance matrices after its first stage
            box = [cosine_distance(qf, idx["gf"]), _euclidean(qf, qf),
                   _euclidean(idx["gf"], idx["gf"])]
            return re_ranking(inputs_box=box, valid=(n_q, n))
        # the gallery-gallery matrix changes only on enrollment: cached per
        # valid count
        if idx.get("gg_n") != n:
            idx["gg"] = _euclidean(idx["gf"], idx["gf"])
            idx["gg_n"] = n
        return re_ranking_padded(cosine_distance(qf, idx["gf"]), _euclidean(qf, qf), idx["gg"], n_q, n)

    def rank_reranked(feats, topk):
        """k-reciprocal re-ranked retrieval (the `rank --rerank` math)
        against the resident index, queries padded to the fixed width.
        Scores are -distance on the blended Jaccard/original scale, ordinal
        only, not comparable to plain rank similarities."""
        n = idx["n"]
        n_q = feats.shape[0]
        if n_q + n < 21:  # k1 + 1: below this the padded top-k clamps
            raise ValueError(  # diverge from the reference's math
                "rerank needs >= 21 total items (k1=20) — enroll more or "
                "rank without rerank"
            )
        if n_q > q_pad:
            raise ValueError(
                f"rerank request has {n_q} queries but the daemon's "
                f"query width is {q_pad} — restart with "
                f"--rerank-queries {n_q} or use 'extract rank --rerank'"
            )
        qf = torch.zeros((q_pad, feats.shape[1]), dtype=torch.float32, device=device)
        qf[:n_q] = torch.from_numpy(feats).to(device)
        scores, order = rerank_topk(rerank_dist(qf, n_q), n)
        scores = scores[:n_q].cpu().numpy()
        order = order[:n_q].cpu().numpy()
        resp = {
            "ok": True, "op": "rank", "reranked": True,
            "results": [
                {"query": r, "matches": matches_of(order[r], scores[r], topk)}
                for r in range(n_q)
            ],
        }
        if n_q + n < 42:  # 2 * (k1 + 1), warn_if_degenerate's regime; the
            # one-shot CLI warns on stderr, a daemon client sees only this
            resp["warning"] = (
                f"re-ranking {n_q + n} items is degenerate below 42 "
                "(2*(k1+1)) — results may be worse than plain rank"
            )
        return resp

    def handle(req):
        op = req.get("op")
        if op == "ping":
            return {
                "ok": True, "op": "ping", "dim": meta["dim"],
                "batch": meta["batch"],
                # clip geometry: a remote client has no other way to learn
                # the shape the artifact was exported for
                "seq_len": meta["seq_len"], "height": meta["height"],
                "width": meta["width"], "channels": meta["channels"],
                "platform": device.type,
                "gallery": idx["n"] if idx is not None else 0,
                "capacity": idx["capacity"] if idx is not None else 0,
                "rerank": bool(idx is not None and not rerank_unavailable),
                "rerank_queries": q_pad if (idx is not None and not rerank_unavailable) else 0,
                # which builder answers rerank requests
                "rerank_staged": bool(idx is not None and rr_staged),
                "rerank_devices": 1,
            }
        if op == "stats":
            # per-op counters + latency aggregates (request wall time incl.
            # the device-serialization wait)
            with lifecycle["lock"]:
                ops = {
                    name: {"n": s["n"], "errors": s["errors"],
                           "ms_mean": round(s["ms_total"] / s["n"], 2),
                           "ms_max": s["ms_max"]}
                    for name, s in stats.items()
                }
            resp = {"ok": True, "op": "stats", "ops": ops,
                    "uptime_s": round(time.time() - lifecycle["t0"], 1),
                    "gallery": idx["n"] if idx is not None else 0}
            resp["describe_batching"] = coalescer.snapshot()
            return resp
        if op == "shutdown":
            return {"ok": True, "op": "shutdown"}
        if op == "describe":
            # no index state touched: describes run concurrently, the
            # coalescer packs them into shared device dispatches
            payload = _describe_payload(coalescer.describe, meta, req["clips"])
            feats = payload["features"]
            resp = {"ok": True, "op": "describe", "n": int(feats.shape[0]),
                    "dim": int(feats.shape[1])}
            if req.get("out"):
                np.savez(req["out"], **payload)
                resp["out"] = req["out"]
            else:
                resp["npz_b64"] = _npz_b64(payload)
            return resp
        if op == "add":
            if idx is None:
                raise ValueError("add needs serve --gallery or --capacity")
            if not ("features" in req or "clips" in req):
                raise ValueError("add needs a 'features' or 'clips' npz path")
            feats, pids, camids = load_add_features(req)  # describe: no lock
            with lifecycle["handle"]:
                enroll(feats, pids, camids)
                return {"ok": True, "op": "add", "added": int(feats.shape[0]),
                        "gallery": idx["n"], "capacity": idx["capacity"]}
        if op == "save":
            if idx is None:
                raise ValueError("save needs serve --gallery or --capacity")
            with lifecycle["handle"]:  # consistent (gf, n, labels) snapshot
                payload = {"features": idx["gf"][: idx["n"]].cpu().numpy(),
                           "pids": idx["pids"], "camids": idx["camids"]}
                n = idx["n"]
            if req.get("out"):
                np.savez(req["out"], **payload)
                return {"ok": True, "op": "save", "n": n, "out": req["out"]}
            return {"ok": True, "op": "save", "n": n, "npz_b64": _npz_b64(payload)}
        if op == "rank":
            if idx is None:
                raise ValueError("rank needs serve --gallery or --capacity")
            if req.get("rerank") and rerank_unavailable:
                raise ValueError(rerank_unavailable)  # config error first
            if ("features" in req) == ("clips" in req):
                raise ValueError(
                    "rank takes exactly one of 'clips' (raw frames) / "
                    "'features' (precomputed descriptors)")
            topk = int(req.get("topk", args.topk))
            if topk < 1:
                raise ValueError("topk must be >= 1")
            if idx["n"] == 0:  # early + cheap; re-checked under the lock
                raise ValueError("index is empty — enroll with add first")
            if "features" in req:
                # precomputed descriptors: the CNN pass is skipped
                src = _load_npz_any(req["features"])
                qf = np.asarray(src["features"], np.float32)
                if qf.ndim != 2 or qf.shape[1] != meta["dim"]:
                    raise ValueError(f"rank features shaped {qf.shape}, need (n, {meta['dim']})")
                if qf.shape[0] == 0:
                    raise ValueError("rank features array is empty")
            else:
                src = _load_npz_any(req["clips"])
                clips = src["clips"]
                _check_clips(clips, meta)
                # raw clips describe outside the index lock, through the
                # coalescer
                qf = coalescer.describe(clips)
            with lifecycle["handle"], torch.inference_mode():
                if idx["n"] == 0:
                    raise ValueError("index is empty — enroll with add first")
                topk = min(topk, k_max, idx["n"])
                if req.get("rerank"):
                    return rank_reranked(qf, topk)
                scores, order = rank_topk_feats(torch.from_numpy(qf).to(device), idx["n"])
                scores, order = scores.cpu().numpy(), order.cpu().numpy()
                results = [{"query": r, "matches": matches_of(order[r], scores[r], topk)}
                           for r in range(qf.shape[0])]
                return {"ok": True, "op": "rank", "results": results}
        raise ValueError(f"unknown op {op!r}")

    if getattr(args, "warmup", False):
        # run every serving path once before accepting requests: CUDA and
        # library initialization, and the min-plus kernel's build at its
        # first use, land here instead of on a live query
        t0 = time.time()
        dummy = np.zeros((meta["batch"], meta["seq_len"], meta["height"],
                          meta["width"], meta["channels"]), np.uint8)
        float(call(dummy)[0, 0])  # descriptor program
        if idx is not None:
            with torch.inference_mode():
                n1 = max(idx["n"], 1)
                float(rank_topk_feats(torch.zeros((meta["batch"], meta["dim"]), device=device), n1)[0][0, 0])
                if not rerank_unavailable:
                    qf0 = torch.zeros((q_pad, meta["dim"]), dtype=torch.float32, device=device)
                    float(rerank_topk(rerank_dist(qf0, 1), n1)[0][0, 0])
        print(f"warmup done in {time.time() - t0:.1f}s", file=sys.stderr)

    print(
        f"serving {args.model} on {device} (batch {meta['batch']}, dim {meta['dim']}"
        + (f", gallery {idx['n']}/{idx['capacity']}" if idx is not None else "")
        + ") — one JSON request per line",
        file=sys.stderr,
    )

    # graceful shutdown state, shared by the signal handler, the shutdown
    # op, and every connection thread. A signal handler may only be
    # installed from the main thread (in-process callers may drive serve()
    # from worker threads; there the shutdown op / EOF path still applies).
    lifecycle = {
        "stop": False,
        "srv": None,
        "conns": set(),
        "lock": threading.Lock(),     # conns set + stats aggregates
        "handle": threading.Lock(),   # serializes device work across clients
        "t0": time.time(),
    }
    stats = {}

    def _stop_everything(why):
        # Finish in-flight requests, then exit cleanly. Blocked syscalls
        # must FAIL rather than be retried (PEP 475 retries after a signal
        # handler returns): full shutdown on the listening socket aborts
        # accept(); read-side shutdown on live connections turns their
        # blocked readline into EOF while each response side still flushes.
        lifecycle["stop"] = True
        print(f"{why}: shutting down", file=sys.stderr)
        if lifecycle["srv"] is not None:
            try:
                lifecycle["srv"].shutdown(socklib.SHUT_RDWR)
            except OSError:
                pass
        with lifecycle["lock"]:
            live = list(lifecycle["conns"])
        for conn in live:
            try:
                conn.shutdown(socklib.SHUT_RD)
            except OSError:
                pass

    # Self-pipe teardown: the handler may interrupt a holder of any
    # non-reentrant lock on the main thread, so it takes no lock, starts no
    # thread and prints nothing. It sets the stop flag and pokes a pipe
    # (os.write is async-signal-safe); a pre-spawned waiter thread blocked
    # in os.read runs the socket teardown.
    _sig_r, _sig_w = os.pipe()

    def _signal_waiter():
        data = os.read(_sig_r, 1)
        if data:  # empty read = pipe closed on the no-signal exit path
            _stop_everything(f"caught signal {int(data[0])}")

    def _graceful(signum, _frame):
        lifecycle["stop"] = True
        try:
            os.write(_sig_w, bytes([signum]))
        except OSError:
            pass  # pipe already closed during shutdown

    prev_handlers, waiter = {}, None
    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _graceful)
        waiter = threading.Thread(target=_signal_waiter, daemon=True)
        waiter.start()
    except ValueError:  # not the main thread
        prev_handlers = {}

    # request lines are read with a hard size cap: inline operands ride
    # base64-npz on the line, so an unbounded readline would let one client
    # balloon host memory before json.loads runs
    max_request_mb = getattr(args, "max_request_mb", 256.0)
    max_line_chars = int(max_request_mb * (1 << 20))

    def _read_bounded_line(fin):
        """readline with a cap; returns (line, oversize?)."""
        line = fin.readline(max_line_chars + 1)
        if len(line) <= max_line_chars or line.endswith("\n"):
            return line, False
        while True:  # discard the rest of the oversize line, 1 MiB at a time
            chunk = fin.readline(1 << 20)
            if not chunk or chunk.endswith("\n"):
                return "", True

    def serve_lines(fin, fout):
        """One JSON-lines conversation; returns (#served, shutdown?)."""
        served = 0
        while True:
            line, oversize = _read_bounded_line(fin)
            if oversize:
                resp = {
                    "ok": False,
                    "error": f"request line exceeds --max-request-mb "
                             f"({max_request_mb:g} MB); send large "
                             f"operands as file paths instead of inline "
                             f"npz_b64, or raise the cap",
                    "ms": 0.0,
                }
                with lifecycle["lock"]:
                    s = stats.setdefault("oversize", {"n": 0, "errors": 0,
                                                      "ms_total": 0.0, "ms_max": 0.0})
                    s["n"] += 1
                    s["errors"] += 1
                fout.write(json.dumps(resp) + "\n")
                fout.flush()  # OSError here = client vanished; conversation logs it
                continue
            if not line:  # EOF
                break
            line = line.strip()
            if not line:
                continue
            t0 = time.perf_counter()
            req = None
            try:
                req = json.loads(line)
                resp = handle(req)
            except Exception as e:  # noqa: BLE001 — per-request isolation
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
                if isinstance(req, dict):  # attribute the error to its op
                    resp["op"] = req.get("op")
            resp["ms"] = round((time.perf_counter() - t0) * 1e3, 2)
            with lifecycle["lock"]:
                s = stats.setdefault(resp.get("op") or "invalid",
                                     {"n": 0, "errors": 0, "ms_total": 0.0, "ms_max": 0.0})
                s["n"] += 1
                s["errors"] += 0 if resp.get("ok") else 1
                s["ms_total"] += resp["ms"]
                s["ms_max"] = max(s["ms_max"], resp["ms"])
            # decide BEFORE the reply write: a client that disconnects
            # without reading its shutdown response must still stop the daemon
            stopping = (
                (resp.get("op") == "shutdown" and resp.get("ok"))
                or lifecycle["stop"]
            )
            try:
                fout.write(json.dumps(resp) + "\n")
                fout.flush()
                served += 1
            except OSError:
                if not stopping:
                    raise  # client vanished mid-reply; conversation logs it
            if stopping:
                return served, True
        return served, False

    def serve_transport():
        if not getattr(args, "listen", ""):
            n, _ = serve_lines(inp, out)
            return n

        # socket mode: clients connect and disconnect freely;
        # {"op": "shutdown"} from any client stops the daemon. TCP binds are
        # for trusted networks (no auth); unix:PATH scopes by file permissions.
        if args.listen.startswith("unix:"):
            path = args.listen[5:]
            try:
                os.unlink(path)
            except OSError:
                pass
            srv = socklib.socket(socklib.AF_UNIX)
            srv.bind(path)
            bound = args.listen
        else:
            host, _, port = args.listen.rpartition(":")
            srv = socklib.socket(socklib.AF_INET)
            srv.setsockopt(socklib.SOL_SOCKET, socklib.SO_REUSEADDR, 1)
            srv.bind((host or "127.0.0.1", int(port)))
            bound = "%s:%d" % srv.getsockname()[:2]  # resolves port 0
        srv.listen(16)
        # accept() wakes every half second to read the stop flag: shutting a
        # listening socket down does not wake a blocked accept() on every
        # kernel (some refuse it with ENOTCONN)
        srv.settimeout(0.5)
        lifecycle["srv"] = srv
        print(f"listening on {bound}", file=sys.stderr, flush=True)
        n_req = [0]
        threads = []

        def conversation(conn):
            # one thread per connected client: an idle client must not
            # block other clients' requests
            stopped = False
            with conn:
                try:
                    served, stopped = serve_lines(
                        conn.makefile("r", encoding="utf-8"),
                        conn.makefile("w", encoding="utf-8"),
                    )
                    with lifecycle["lock"]:
                        n_req[0] += served
                except OSError as e:  # client vanished mid-reply
                    print(f"client dropped: {e}", file=sys.stderr)
                finally:
                    with lifecycle["lock"]:
                        lifecycle["conns"].discard(conn)
            if stopped and not lifecycle["stop"]:
                _stop_everything("shutdown op")  # from any client

        try:
            while not lifecycle["stop"]:
                try:
                    conn, _peer = srv.accept()
                except socklib.timeout:
                    continue
                except OSError:
                    if lifecycle["stop"]:  # _stop_everything aborted accept
                        break
                    raise
                with lifecycle["lock"]:
                    lifecycle["conns"].add(conn)
                if lifecycle["stop"]:
                    # raced _stop_everything's conns snapshot: deliver the
                    # EOF it would have sent, or this reader blocks forever
                    try:
                        conn.shutdown(socklib.SHUT_RD)
                    except OSError:
                        pass
                t = threading.Thread(target=conversation, args=(conn,), daemon=True)
                t.start()
                # reap finished conversations so a long-lived daemon's
                # thread list does not grow with every connection
                threads[:] = [x for x in threads if x.is_alive()]
                threads.append(t)
            for t in threads:  # in-flight requests finish; readers got EOF
                t.join()
        finally:
            srv.close()
            if args.listen.startswith("unix:"):
                try:
                    os.unlink(args.listen[5:])
                except OSError:
                    pass
        return n_req[0]

    try:
        return serve_transport()
    finally:
        for sig, handler in prev_handlers.items():
            signal.signal(sig, handler)
        # unblock the signal waiter (os.read returns b"" on writer close) and
        # wait for it: a signal that lands while the accept loop is between
        # two accept() calls stops the loop through the flag alone, and the
        # waiter must still run its teardown and log before the process ends
        try:
            os.close(_sig_w)
        except OSError:
            pass
        if waiter is not None:
            waiter.join(timeout=10)
        if waiter is None or not waiter.is_alive():
            os.close(_sig_r)


def build_parser():
    cfg = ExperimentConfig()
    parser = argparse.ArgumentParser(description="GRL descriptor extraction / retrieval (PyTorch/CUDA)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default cuda; cpu runs on the host); "
                             "goes before the subcommand")
    sub = parser.add_subparsers(dest="command", required=True)

    f = sub.add_parser("features", help="extract tracklet descriptors to .npz")
    f.add_argument("-d", "--dataset", type=str, default=cfg.data.dataset,
                   choices=["ilidsvidsequence", "prid2011sequence", "mars", "duke", "synthetic"])
    f.add_argument("--data-dir", type=str, default="")
    f.add_argument("--split", type=str, default="gallery", choices=["query", "gallery"])
    f.add_argument("--split-id", type=int, default=0, dest="split_id")
    f.add_argument("--seq_len", type=int, default=cfg.data.seq_len)
    f.add_argument("--seq_srd", type=int, default=cfg.data.seq_srd)
    f.add_argument("-j", "--workers", type=int, default=cfg.data.workers)
    f.add_argument("--logs-dir", type=str, default="log/grl")
    f.add_argument("--checkpoint", type=str, default="",
                   help="explicit checkpoint (default: logs-dir/checkpoint_best.npz)")
    f.add_argument("-o", "--out", type=str, required=True)
    f.add_argument("--micro-batch", type=int, default=cfg.eval.micro_batch)
    f.add_argument("--rrs", action="store_true",
                   help="one RRS clip per tracklet instead of dense (faster, lossier)")
    f.add_argument("--arch1", type=str, default=cfg.model.arch1)
    f.add_argument("--arch2", type=str, default=cfg.model.arch2)
    f.add_argument("--features", type=int, default=cfg.model.features)
    f.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    f.add_argument("--tiny", action="store_true")
    f.add_argument("--use-flow", action="store_true",
                   help="sequence datasets only: 6-channel RGB|flow clips (a flow-trained checkpoint)")
    f.add_argument("--seed", type=int, default=cfg.seed)
    f.add_argument("--synthetic-ids", type=int, default=0,
                   help="-d synthetic: must match the value the checkpoint "
                        "was trained with (regenerates the same catalog)")
    f.add_argument("--devices", type=int, default=0,
                   help="cap the data-parallel card count (0 = every visible card; with --device cpu, "
                        "the number of gloo ranks)")

    r = sub.add_parser("rank", help="rank queries against a gallery index")
    r.add_argument("--query", type=str, required=True)
    r.add_argument("--gallery", type=str, required=True)
    r.add_argument("--topk", type=int, default=10)
    r.add_argument("--rerank", action="store_true")
    r.add_argument("-o", "--out", type=str, required=True)

    e = sub.add_parser(
        "export-model",
        help="serialize the descriptor program (weights inside) as a torch.export "
             "artifact that runs with no model code",
    )
    e.add_argument("--logs-dir", type=str, default="log/grl")
    e.add_argument("--checkpoint", type=str, default="",
                   help="explicit checkpoint (default: logs-dir/checkpoint_best.npz)")
    e.add_argument("--num-classes", type=int, default=625,
                   help="train-id count baked into the checkpoint's OIM "
                        "tables (MARS: 625); a wrong value fails the "
                        "checkpoint load with a shape mismatch")
    e.add_argument("--batch", type=int, default=cfg.eval.micro_batch,
                   help="fixed clip batch the program is exported at "
                        "(describe pads the final chunk)")
    e.add_argument("--seq_len", type=int, default=cfg.data.seq_len)
    e.add_argument("--height", type=int, default=cfg.data.height)
    e.add_argument("--width", type=int, default=cfg.data.width)
    e.add_argument("--platforms", type=str, default="",
                   help="the export's device type; must match --device (default: it)")
    e.add_argument("--arch1", type=str, default=cfg.model.arch1)
    e.add_argument("--arch2", type=str, default=cfg.model.arch2)
    e.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    e.add_argument("--tiny", action="store_true")
    e.add_argument("--use-flow", action="store_true",
                   help="export for 6-channel RGB|flow clips (a flow-trained checkpoint)")
    e.add_argument("--seed", type=int, default=cfg.seed)
    e.add_argument("-o", "--out", type=str, required=True)

    d = sub.add_parser(
        "describe",
        help="run a clips .npz through an export-model artifact "
             "(no model code, no checkpoint)",
    )
    d.add_argument("--model", type=str, required=True)
    d.add_argument("--clips", type=str, required=True,
                   help=".npz with 'clips' (n, seq_len, h, w, c) uint8 "
                        "(+ optional pids/camids, passed through)")
    d.add_argument("-o", "--out", type=str, required=True)

    s = sub.add_parser(
        "serve",
        help="persistent descriptor/retrieval daemon over an export-model "
             "artifact: JSON-lines requests on stdin, responses on stdout",
    )
    s.add_argument("--model", type=str, required=True, help="export-model artifact (.npz)")
    s.add_argument("--gallery", type=str, default="",
                   help="gallery index .npz (features/pids/camids, e.g. from "
                        "'features' or 'describe') enabling the rank op; "
                        "held on the device for the session")
    s.add_argument("--topk", type=int, default=10,
                   help="max matches per rank query (requests may ask less)")
    s.add_argument("--capacity", type=int, default=0,
                   help="index capacity for add-op enrollment (the device "
                        "buffer is sized to this once); 0 = frozen at the "
                        "--gallery size; with no --gallery, starts an empty index")
    s.add_argument("--rerank-queries", type=int, default=16, dest="rerank_queries",
                   help="max queries per rerank request (queries are padded "
                        "to this width, rounded up to the batch; larger "
                        "requests are rejected)")
    s.add_argument("--warmup", action="store_true",
                   help="run every serving path once (describe, rank, "
                        "rerank; the min-plus kernel's build) before "
                        "accepting requests")
    s.add_argument("--devices", type=int, default=1,
                   help="cards to row-shard the rerank set algebra over; above 1 "
                        "is not ported yet (ROADMAP queue A, item 7)")
    s.add_argument("--listen", type=str, default="",
                   help="serve over a socket instead of stdin/stdout: "
                        "'host:port' (port 0 picks one; the bound address "
                        "prints to stderr) or 'unix:/path'. Clients "
                        "connect/disconnect freely and are served "
                        "concurrently (device work serialized); a "
                        "shutdown op from any client, or SIGTERM/SIGINT, "
                        "stops the daemon cleanly. The protocol has no auth "
                        "and file-path operands read the daemon's "
                        "filesystem: bind TCP only on trusted networks")
    s.add_argument("--max-request-mb", type=float, default=256.0, dest="max_request_mb",
                   help="hard cap on one request line (MB); an oversize line "
                        "is drained in bounded chunks and answered "
                        "{\"ok\": false} with the connection kept alive")
    return parser


def main(args):
    set_precision()
    if args.command == "rank":
        return rank(args)
    if args.command == "export-model":
        return export_model(args)
    if args.command == "describe":
        return describe_with_export(args)
    if args.command == "serve":
        return serve(args)
    return extract_split(args)


def cli():
    """Console-script entry point; swallows ``main``'s return value, which
    ``sys.exit`` would read as a failure."""
    main(build_parser().parse_args())


if __name__ == "__main__":
    cli()
