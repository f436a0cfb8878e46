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
code, and on the card replay it as one CUDA graph of the export batch
(``--device cpu`` runs its ops eagerly). Every re-ranked answer ends in the
min-plus kernel on the card.
``main`` runs in fp32 with TF32 off; ``features --bf16`` and
``export-model --bf16`` compute in bfloat16 (descriptors stay fp32), and a
bf16 artifact is described and served as an fp32 one. ``features
--use-flow`` reads 6-channel RGB|flow clips (iLIDS-VID, PRID-2011), and
``export-model --use-flow`` exports the program for them (``"channels": 6``
in its meta), which ``describe`` and ``serve`` then take and which refuse
3-channel clips. ``features --devices N`` (default 0: every visible card)
describes the split on one rank per card (N gloo ranks under ``--device
cpu``), each its stripe, and rank 0 writes the assembled rows in catalog
order. ``serve --devices N`` re-ranks on N ranks (one per card; N gloo
ranks under ``--device cpu``) through the row-sharded staged builder: this
process is rank 0 and owns the socket, the others are started beside it
(or all come from ``torchrun``) and take their share of each re-ranked
request; on one card it runs one rank on the staged route and says so.

``rank`` does NOT prepend queries to the gallery and does not junk-filter:
it is retrieval, not CMC.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os.path as osp
import threading
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel, resolve_device, set_precision
from ..config import ExperimentConfig
from ..data import get_data
from ..engine import Evaluator, init_train_state, rerank
from ..engine.evaluator import _euclidean, cosine_distance, make_descriptor_fn, rerank_columns, rerank_inputs
from ..engine.rerank import re_ranking, re_ranking_padded, top_k, warn_if_degenerate
from ..utils import load_train_state
from ..utils.profiling import span
from .train import _synthetic_kwargs, build_models, eval_meta, ranks_to_launch, say_one_device
from .transport import Transport

_ADD_BLOCK = 256  # serve's enrollment granularity
# torch.export.save writes a zip archive; jax.export blobs are flatbuffers
_ZIP_MAGIC = b"PK\x03\x04"


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
    if args.rerank:
        warn_if_degenerate(qf.shape[0] + gf.shape[0])
        distmat = re_ranking(inputs_box=rerank_inputs(qf, gf))
    else:
        distmat = cosine_distance(qf, gf)
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
    # the saved program keeps its example inputs unless they are cleared: a
    # zero batch as large as a request (25.2 MB at batch 32 x 8 x 256x128
    # RGB). The program's signature and ``meta`` carry the shapes.
    program.example_inputs = None
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


class _GraphCall:
    """The artifact's program on a CUDA device as one CUDA graph of the
    export batch: captured once, at load, and replayed by every call.

    A dispatch is then a copy in through a pinned host buffer, one replay
    and a copy back, where the loaded ``GraphModule`` would issue each of
    its ops from Python (710 for the fp32 RGB descriptor). ``replays`` counts the replays. A call holds
    its own lock around the static buffers and returns a fresh array. A
    failed capture or replay raises; nothing runs the eager program here."""

    _WARMUP = 3  # eager runs on a side stream before the capture (cuDNN, cuBLAS, the allocator)

    def __init__(self, program, meta, device):
        self.shape = (meta["batch"], meta["seq_len"], meta["height"], meta["width"], meta["channels"])
        self.replays = 0
        self._lock = threading.Lock()
        self._program = program  # the graph reads its weights where they lie
        with torch.cuda.device(device), torch.inference_mode():
            self._in = torch.zeros(self.shape, dtype=torch.uint8, device=device)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(self._WARMUP):
                    program(self._in)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            # the capture empties the allocator's cache first; empty it
            # here so that what it reserves is the graph's private pool
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._out = program(self._in).to(torch.float32)
            torch.cuda.synchronize()
            # device bytes the capture reserved: the graph's private pool
            self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self._host_in = torch.empty(self.shape, dtype=torch.uint8, pin_memory=True)
        self._host_out = torch.empty(self._out.shape, dtype=torch.float32, pin_memory=True)
        # a blocking event: the leading thread sleeps through the replay
        # instead of spinning on a core that the connection threads want
        self._done = torch.cuda.Event(blocking=True)
        self._device = torch.device(device)

    def __call__(self, chunk):
        chunk = np.asarray(chunk)
        if chunk.shape != self.shape or chunk.dtype != np.uint8:
            raise ValueError(f"chunk {chunk.dtype} {chunk.shape}; the graph takes uint8 {self.shape}")
        with self._lock, torch.cuda.device(self._device), torch.inference_mode():
            self._host_in.numpy()[...] = chunk
            self._in.copy_(self._host_in, non_blocking=True)
            self.graph.replay()
            self._host_out.copy_(self._out, non_blocking=True)
            self._done.record()
            self._done.synchronize()
            self.replays += 1
            return self._host_out.numpy().copy()


def _load_artifact(path, device):
    """Load an ``export-model`` artifact -> ``(call, meta)``. ``call`` takes a
    uint8 numpy chunk of the export batch and returns float32 numpy
    descriptors, computed on ``device`` under ``torch.inference_mode``: on a
    CUDA device it replays one CUDA graph of the program (``_GraphCall``),
    on the CPU it runs the program's ops eagerly. Refuses, at load, an
    artifact exported for another device and one that ``jax.export`` wrote
    (grl_tpu's)."""
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
    if device.type == "cuda":
        return _GraphCall(program, meta, device), meta

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


class _DeviceLock:
    """The coalescer's device lock: held by the thread that leads a
    dispatch. Its state lives under the coalescer's condition, so a release
    wakes every waiter at once: the ones whose rows the dispatch carried
    return, and one of the rest leads the next."""

    def __init__(self, cv):
        self._cv = cv
        self.busy = False

    def acquire(self, blocking=True):
        with self._cv:
            if blocking:
                self._cv.wait_for(lambda: not self.busy)
            elif self.busy:
                return False
            self.busy = True
            return True

    def release(self):
        with self._cv:
            self.busy = False
            self._cv.notify_all()


class _DescribeCoalescer:
    """Cross-request descriptor batching for the serve daemon.

    Concurrent connections' clips pack into shared device dispatches of
    the artifact's batch width, with no timers and no background thread:
    whichever waiter finds the device free first leads a dispatch, draining
    queued work FIFO up to the batch width; everyone else sleeps until a
    dispatch ends, then either has their rows or leads the next dispatch.
    A lone request therefore dispatches immediately with exactly the
    sequential path's chunking and padding (bit-identical results, no added
    latency when idle); under concurrent load, small requests share batches
    instead of each paying a padded dispatch.
    """

    def __init__(self, call, batch):
        self._call, self._batch = call, batch
        self._q = []
        self._qlock = threading.Lock()
        # one condition for the queue, the device and every waiter's rows
        self._cv = threading.Condition(self._qlock)
        self._device = _DeviceLock(self._cv)
        # observability (reported by the daemon's stats op)
        self.dispatches = 0   # device calls issued
        self.clips = 0        # valid clips described
        self.packed = 0       # dispatches carrying >1 waiter's clips

    def describe(self, clips):
        """(n, S, H, W, C) uint8 -> (n, dim) float32 descriptors."""
        items = [
            {"clips": clips[i : i + self._batch],
             "done": threading.Event(), "out": None, "err": None}
            for i in range(0, clips.shape[0], self._batch)
        ]
        with self._qlock:
            self._q.extend(items)
        for item in items:
            while True:
                # sleep until this item's dispatch ends or the device is
                # free; then return, or lead a dispatch (of the FIFO head,
                # not necessarily of this item)
                with self._cv:
                    self._cv.wait_for(lambda: item["done"].is_set() or not self._device.busy)
                    if item["done"].is_set():
                        break
                    self._device.busy = True
                try:
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


def _open_index(args, meta, device, mesh=None):
    """serve's ``_GalleryIndex`` on ``device`` (each rank of ``mesh`` holds
    one), or None without ``--gallery`` or ``--capacity``."""
    if not (args.gallery or args.capacity):
        return None
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
    if args.rerank_queries < 1:
        raise SystemExit("serve --rerank-queries must be >= 1")
    # the rerank geometry is fixed at startup: queries pad to a fixed
    # width, the index to its buffer
    q_pad = meta["batch"] * -(-args.rerank_queries // meta["batch"])
    # --devices above 1 re-ranks through the staged builder, row-sharded
    # over the group when it has more than one rank (grl_tpu: a mesh
    # forces the staged route)
    return _GalleryIndex(feats, labels["pids"], labels["camids"], max(args.capacity, feats.shape[0]), q_pad,
                         args.topk, device, staged=args.devices > 1, mesh=mesh)


class _GalleryIndex:
    """serve's gallery index on the device, and its ranking.

    The features sit in a buffer of ``capacity`` + one enrollment block of
    rows, zeros past the valid count ``n`` and masked out of every ranking;
    the labels sit beside them. Re-ranking pads the queries to ``q_pad``
    rows, and its route is fixed here: the group's row-sharded staged
    builder under ``mesh`` (``_RerankGroup``); the staged builder with
    ``valid`` when ``staged`` or past ``rerank.ONE_PROGRAM_MAX`` items; else
    ``re_ranking_padded`` over a g×g matrix cached per valid count.

    One lock serializes the index's reads, writes and device work; ``rank``
    and ``rank_reranked`` span its wait and hold (``_held``)."""

    def __init__(self, feats, pids, camids, capacity, q_pad, topk, device, staged=False, mesh=None):
        self.device = device
        self.n, self.capacity, self.q_pad = feats.shape[0], capacity, q_pad
        self.k_max = min(topk, capacity)
        self.pids, self.camids = pids, camids
        # one spare enrollment block, so a fixed-width block never runs past
        # the buffer
        self.gf = torch.zeros((capacity + _ADD_BLOCK, feats.shape[1]), dtype=torch.float32, device=device)
        self.gf[: self.n] = torch.from_numpy(np.asarray(feats, np.float32))
        self.staged = staged or q_pad + self.gf.shape[0] > rerank.ONE_PROGRAM_MAX
        self.group = _RerankGroup(mesh, self) if mesh is not None else None
        self._gg, self._gg_n = None, None  # the padded route's cached g×g, and its valid count
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def _held(self):
        """The lock, its wait spanned as ``serve.lock_wait``, its hold as ``serve.lock_held``."""
        with span("serve.lock_wait"):
            self._lock.acquire()
        try:
            with span("serve.lock_held"):
                yield
        finally:
            self._lock.release()

    def enroll(self, feats, pids, camids):
        """Append descriptor rows and their labels; returns the new count."""
        with self._lock:
            n, n_add = self.n, feats.shape[0]
            if n + n_add > self.capacity:
                raise ValueError(
                    f"index at {n}/{self.capacity}: adding {n_add} exceeds "
                    "capacity — restart serve with a larger --capacity"
                )
            for i in range(0, n_add, _ADD_BLOCK):
                block = feats[i : i + _ADD_BLOCK]
                if block.shape[0] < _ADD_BLOCK:  # zero-pad: rows past the new
                    block = np.concatenate(     # count stay masked out of rank
                        [block, np.zeros((_ADD_BLOCK - block.shape[0], block.shape[1]), np.float32)]
                    )
                self.gf[n + i : n + i + _ADD_BLOCK] = torch.from_numpy(block).to(self.device)
            self.n = n + n_add
            self.pids = np.concatenate([self.pids, pids])
            self.camids = np.concatenate([self.camids, camids])
            return self.n

    def save(self):
        """A consistent ``(payload, n)`` snapshot of the valid rows."""
        with self._lock:
            return {"features": self.gf[: self.n].cpu().numpy(), "pids": self.pids, "camids": self.camids}, self.n

    def rank(self, qf, topk):
        """Plain retrieval of (n_q, dim) float32 query features: the rank
        op's ``results``. Scores are cosine similarities (the rank
        subcommand's negative-distance convention)."""
        with self._held(), torch.inference_mode():
            topk = self._clamp(topk)
            scores, order = self._top_k(torch.from_numpy(qf).to(self.device) @ self.gf.T, self.n)
            return {"results": self._results(scores, order, qf.shape[0], topk)}

    def rank_reranked(self, qf, topk):
        """k-reciprocal re-ranked retrieval (the `rank --rerank` math) of
        (n_q, dim) float32 query features, padded to ``q_pad`` rows. Scores
        are -distance on the blended Jaccard/original scale, ordinal only,
        not comparable to plain rank similarities."""
        with self._held(), torch.inference_mode():
            topk = self._clamp(topk)
            n, n_q = self.n, qf.shape[0]
            if n_q + n < 21:  # k1 + 1: below this the padded top-k clamps
                raise ValueError(  # diverge from the reference's math
                    "rerank needs >= 21 total items (k1=20) — enroll more or "
                    "rank without rerank"
                )
            if n_q > self.q_pad:
                raise ValueError(
                    f"rerank request has {n_q} queries but the daemon's "
                    f"query width is {self.q_pad} — restart with "
                    f"--rerank-queries {n_q} or use 'extract rank --rerank'"
                )
            padded = torch.zeros((self.q_pad, qf.shape[1]), dtype=torch.float32, device=self.device)
            padded[:n_q] = torch.from_numpy(qf).to(self.device)
            scores, order = self._top_k(-self._reranked(padded, n_q), n)
            resp = {"reranked": True, "results": self._results(scores, order, n_q, topk)}
            if n_q + n < 42:  # 2 * (k1 + 1), warn_if_degenerate's regime; the
                # one-shot CLI warns on stderr, a daemon client sees only this
                resp["warning"] = (
                    f"re-ranking {n_q + n} items is degenerate below 42 "
                    "(2*(k1+1)) — results may be worse than plain rank"
                )
            return resp

    def warm_up(self, rows):
        """Both rankings once, plain over ``rows`` queries and re-ranked, so
        that library set-up and the min-plus and nearest kernels' builds
        land before the first request."""
        with torch.inference_mode():
            n1 = max(self.n, 1)
            float(self._top_k(torch.zeros((rows, self.gf.shape[1]), device=self.device) @ self.gf.T, n1)[0][0, 0])
            qf0 = torch.zeros((self.q_pad, self.gf.shape[1]), dtype=torch.float32, device=self.device)
            float(self._top_k(-self._reranked(qf0, 1), n1)[0][0, 0])

    def _clamp(self, topk):
        """``topk`` cut to ``k_max`` and to the (non-zero) valid count."""
        if self.n == 0:
            raise ValueError("index is empty — enroll with add first")
        return min(topk, self.k_max, self.n)

    def _top_k(self, scores, n):
        """The ``k_max`` highest ``scores`` of each row, the columns past the
        valid count ``n`` masked to -inf (the zero rows' similarity 0 would
        beat genuinely negative matches)."""
        cols = torch.arange(scores.shape[1], device=self.device)[None, :]
        return top_k(torch.where(cols < n, scores, -torch.inf), self.k_max)

    def _results(self, scores, order, n_q, topk):
        """The first ``topk`` matches of the first ``n_q`` rows, labelled."""
        with span("serve.read"):
            scores, order = scores[:n_q].cpu().numpy(), order[:n_q].cpu().numpy()
        with span("serve.respond"):
            return [{"query": r, "matches": [{"gallery": int(j), "pid": int(self.pids[j]),
                                              "camid": int(self.camids[j]), "score": float(s)}
                                             for j, s in zip(order[r, :topk], scores[r, :topk])]}
                    for r in range(n_q)]

    def _reranked(self, qf, n_q):
        """(q_pad, dim) padded query features -> (q_pad, G) re-ranked
        distances on this index's route; rows past n_q and columns past
        ``n`` are garbage."""
        n = self.n
        if self.group is not None:
            return self.group.rerank(qf, n_q)
        if self.staged:
            # g×g is not cached on this route: the staged builder frees the
            # distance matrices after its first stage
            with span("rerank.distances", device=self.device):
                box = rerank_inputs(qf, self.gf)
            return re_ranking(inputs_box=box, valid=(n_q, n))
        with span("rerank.distances", device=self.device):
            # the gallery-gallery matrix changes only on enrollment
            if self._gg_n != n:
                self._gg, self._gg_n = _euclidean(self.gf, self.gf), n
            box = rerank_inputs(qf, self.gf, self._gg)
        return re_ranking_padded(*box, n_q, n)


class _RerankGroup:
    """``serve --devices``' re-ranked requests over the group. For each one
    rank 0 posts a header on the rendezvous store (the op, the valid query
    and index counts, and how far the peers' index copies reach), where the
    peers wait with no deadline between requests; then it broadcasts the
    index rows enrolled since the last request and the padded query
    features, and every rank runs ``re_ranking(mesh=)`` on its rows. Every
    rank's index thus takes rank 0's rows, in order, before its block is
    built. ``stop`` ends the peers' loop."""

    def __init__(self, mesh, index):
        self.mesh, self.index = mesh, index
        self.seq = 0
        self.synced = index.n  # the index rows every rank holds

    def _key(self):
        return f"grl_tpu_torch:serve:{self.seq}"

    def _post(self, head):
        self.mesh.store.set(self._key(), json.dumps(head))
        self.seq += 1

    def receive(self):
        """The next header (a peer's wait: an hour at a time, for ever)."""
        key = self._key()
        while True:
            try:
                self.mesh.store.wait([key], timedelta(hours=1))
                break
            except RuntimeError as e:
                if "timeout" not in str(e).lower():
                    raise
        self.seq += 1
        return json.loads(self.mesh.store.get(key))

    def rerank(self, qf, n_q):
        """Rank 0: one request's re-ranked (q_pad, G) distances."""
        self._post({"op": "rerank", "nq": n_q, "n": self.index.n, "synced": self.synced})
        return self._run(qf, n_q, self.synced, self.index.n)

    def follow(self):
        """A peer: take part in requests until rank 0 stops; returns how many."""
        served = 0
        while (head := self.receive())["op"] == "rerank":
            qf = torch.empty((self.index.q_pad, self.index.gf.shape[1]), device=self.index.gf.device)
            self._run(qf, head["nq"], head["synced"], head["n"])
            self.index.n = head["n"]
            served += 1
        return served

    def _run(self, qf, n_q, synced, n):
        gf = self.index.gf
        if n > synced:
            dist.broadcast(gf[synced:n], src=0)
        self.synced = n
        dist.broadcast(qf, src=0)
        return re_ranking(inputs_box=[rerank_columns(qf, gf, self.mesh)], query_num=qf.shape[0],
                          valid=(n_q, n), mesh=self.mesh)

    def stop(self):
        self._post({"op": "stop"})


def _serve_peer(args):
    """Ranks 1 and on of ``serve --devices``: the same index as rank 0's,
    and their share of every re-ranked request until rank 0 stops the
    group. SIGTERM and SIGINT are rank 0's to act on: a peer leaves when
    rank 0's stop reaches it (or with rank 0's process)."""
    import signal
    import sys

    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    mesh = parallel.current_mesh()
    with np.load(args.model, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
    index = _open_index(args, meta, mesh.device, mesh)
    if index is None:
        return 0
    with torch.inference_mode():
        served = index.group.follow()
    print(f"serve rank {mesh.rank} of {mesh.size}: stopped by rank 0 after {served} re-ranked requests",
          file=sys.stderr)
    return served


def _add_operands(req, meta, describe):
    """An add request's rows and labels: its descriptors, or its raw clips
    through ``describe``."""
    src = _load_npz_any(req["features"] if "features" in req else req["clips"])
    if "features" in req:
        feats = np.asarray(src["features"], np.float32)
        if feats.ndim != 2 or feats.shape[1] != meta["dim"]:
            raise ValueError(f"add features shaped {feats.shape}, need (n, {meta['dim']})")
    else:
        clips = src["clips"]
        _check_clips(clips, meta)
        feats = describe(clips)
    labels = {}
    for k in ("pids", "camids"):
        labels[k] = (np.asarray(src[k], np.int64) if k in src.files
                     else np.full(feats.shape[0], -1, np.int64))
        if labels[k].shape != (feats.shape[0],):
            raise ValueError(f"{k} shaped {labels[k].shape}, need ({feats.shape[0]},)")
    return feats, labels["pids"], labels["camids"]


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
    takes raw ``clips`` or precomputed ``features``.

    Three parts: the transport (``transport.Transport``), the index
    (``_GalleryIndex``: its device rows, its lock and its re-ranking route)
    and, here, ``handle``, the ops. Clips are described outside the index
    lock, through a coalescer that packs concurrent requests into shared
    dispatches. Under ``--devices`` this process is rank 0 and owns the
    transport, describe, plain rank and enrollment; the other ranks
    (``_serve_peer``) hold the same index and take their share of each
    re-ranked request (``_RerankGroup``).

    A malformed request gets ``{"ok": false, "error": ...}`` and the loop
    goes on; every response carries ``ms``. SIGTERM/SIGINT finish the
    in-flight request and stop the daemon cleanly.

    While a ``torch.profiler`` session is active in the daemon's process
    (an operator profiling it), a ``rank`` response also carries
    ``"spans"``: the request's spans (``utils.profiling.Span``'s fields as
    a list, times on the daemon's ``time.time_ns()`` clock) that ended
    before the response was built: ``serve.decode``, ``serve.lock_wait``,
    ``serve.lock_held`` with ``serve.read`` and ``serve.respond`` under it,
    and re-ranking's ``rerank.*`` stages with each one's device
    milliseconds. ``ServeClient`` takes them off the response and records
    them in its own process (``utils.profiling.record``). Without a
    profiler no response carries them.
    """
    import sys
    import time

    inp = inp if inp is not None else sys.stdin
    out = out if out is not None else sys.stdout
    mesh = parallel.maybe_initialize_distributed(args.device)
    if mesh is None and args.devices > 1:
        n = parallel.auto_mesh(limit=args.devices, device=args.device)
        if n > 1:
            # this process is rank 0 (stdin, the socket, signals); the peers
            # start beside it
            return parallel.launch(_serve_peer, args, n, args.device, here=functools.partial(serve, args, inp, out))[0]
        print(f"--devices {args.devices}: running on one {args.device} device "
              f"({parallel.visible_devices(args.device)} visible); re-ranking on the staged route",
              file=sys.stderr)
    if mesh is not None and mesh.rank > 0:
        return _serve_peer(args)
    device = resolve_device(args.device) if mesh is None else mesh.device

    call, meta = _load_artifact(args.model, device)
    # every clip-describe site (describe/add/rank) funnels through the
    # coalescer: concurrent connections' clips share device dispatches
    coalescer = _DescribeCoalescer(call, meta["batch"])
    index = _open_index(args, meta, device, mesh)
    transport = Transport(getattr(args, "listen", ""), getattr(args, "max_request_mb", 256.0))

    def handle(req):
        op = req.get("op")
        if op in ("add", "save", "rank") and index is None:
            raise ValueError(f"{op} needs serve --gallery or --capacity")
        if op == "ping":
            return {
                "ok": True, "op": "ping", "dim": meta["dim"],
                "batch": meta["batch"],
                # clip geometry: a remote client has no other way to learn
                # the shape the artifact was exported for
                "seq_len": meta["seq_len"], "height": meta["height"],
                "width": meta["width"], "channels": meta["channels"],
                "platform": device.type,
                "gallery": index.n if index is not None else 0,
                "capacity": index.capacity if index is not None else 0,
                "rerank": index is not None,
                "rerank_queries": index.q_pad if index is not None else 0,
                # which builder answers rerank requests
                "rerank_staged": index is not None and index.staged,
                # ranks the n² re-ranking is row-sharded over
                "rerank_devices": mesh.size if index is not None and mesh is not None else 1,
            }
        if op == "stats":
            return {"ok": True, "op": "stats", **transport.stats(),
                    "gallery": index.n if index is not None else 0,
                    "describe_batching": coalescer.snapshot()}
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
            if not ("features" in req or "clips" in req):
                raise ValueError("add needs a 'features' or 'clips' npz path")
            feats, pids, camids = _add_operands(req, meta, coalescer.describe)  # describe: no lock
            n = index.enroll(feats, pids, camids)
            return {"ok": True, "op": "add", "added": int(feats.shape[0]),
                    "gallery": n, "capacity": index.capacity}
        if op == "save":
            payload, n = index.save()
            if req.get("out"):
                np.savez(req["out"], **payload)
                return {"ok": True, "op": "save", "n": n, "out": req["out"]}
            return {"ok": True, "op": "save", "n": n, "npz_b64": _npz_b64(payload)}
        if op == "rank":
            if ("features" in req) == ("clips" in req):
                raise ValueError(
                    "rank takes exactly one of 'clips' (raw frames) / "
                    "'features' (precomputed descriptors)")
            topk = int(req.get("topk", args.topk))
            if topk < 1:
                raise ValueError("topk must be >= 1")
            if index.n == 0:  # early + cheap; re-checked under the lock
                raise ValueError("index is empty — enroll with add first")
            if "features" in req:
                # precomputed descriptors: the CNN pass is skipped
                with span("serve.decode"):
                    src = _load_npz_any(req["features"])
                    qf = np.asarray(src["features"], np.float32)
                    if qf.ndim != 2 or qf.shape[1] != meta["dim"]:
                        raise ValueError(f"rank features shaped {qf.shape}, need (n, {meta['dim']})")
                    if qf.shape[0] == 0:
                        raise ValueError("rank features array is empty")
            else:
                with span("serve.decode"):
                    src = _load_npz_any(req["clips"])
                    clips = src["clips"]
                    _check_clips(clips, meta)
                # raw clips describe outside the index lock, through the
                # coalescer
                qf = coalescer.describe(clips)
            ranked = index.rank_reranked(qf, topk) if req.get("rerank") else index.rank(qf, topk)
            return {"ok": True, "op": "rank", **ranked}
        raise ValueError(f"unknown op {op!r}")

    if getattr(args, "warmup", False):
        # run every serving path once before accepting requests: CUDA and
        # library initialization, and the min-plus and nearest kernels'
        # builds at their first use, land here instead of on a live query
        t0 = time.time()
        dummy = np.zeros((meta["batch"], meta["seq_len"], meta["height"],
                          meta["width"], meta["channels"]), np.uint8)
        float(call(dummy)[0, 0])  # descriptor program
        if index is not None:
            index.warm_up(meta["batch"])
        print(f"warmup done in {time.time() - t0:.1f}s", file=sys.stderr)

    print(
        f"serving {args.model} on {device} (batch {meta['batch']}, dim {meta['dim']}"
        + (f", gallery {index.n}/{index.capacity}" if index is not None else "")
        + ") — one JSON request per line",
        file=sys.stderr,
    )
    try:
        return transport.run(handle, inp, out)
    finally:
        if index is not None and index.group is not None:
            index.group.stop()


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
                   help="row-shard the n^2 rerank set algebra over this many ranks, one per "
                        "card (capped at the visible cards; with --device cpu, gloo ranks); "
                        "above 1 forces the staged builder. This process is rank 0 and "
                        "describes on its card alone")
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
