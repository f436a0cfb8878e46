"""Retrieval evaluator: descriptor extraction + cosine ranking + CMC/mAP
(counterpart of ``grl_tpu/engine/evaluator.py``).

- descriptor per clip = concat(x_uncorr, attention-pooled x_corr, temporal
  mean of x_corr) -> 3·C dims (6144 for ResNet-50);
- dense path: every consecutive clip of a tracklet is described and the
  descriptors averaged; clips of many tracklets are packed into each
  micro-batch and added into per-tracklet sums on the device; a
  micro-batch is copied once, into one of two reused staging slots (pinned
  on a card, so its upload waits for nothing and the host fills the next
  slot while the card describes this one);
- rrs_test path: one clip per tracklet, rows written in order, through
  ``describe_clips`` (each chunk padded to one of a few fixed shapes, as
  grl_tpu pads it);
- gallery := query ∪ gallery, cosine distance ``-qf @ gfᵀ``, optional
  k-reciprocal re-ranking on the device (with the min-plus kernel; the
  staged builder above n = 16384 items, as grl_tpu), and the
  MARS protocol on the device; ``save_distmat`` writes the final distance
  matrix and ids to an npz with grl_tpu's keys, and ``visual_dir`` gets
  the ranked strips of that matrix (``engine/visualize.py``).

Features and distance matrices stay on the device; only the CMC curve and
mAP come back to the host.

Under a profiler (``utils.profiling.span``) each ``extract_features`` call
is an ``evaluator.extract_features`` span; on the dense path it holds
``evaluator.loader_wait`` (the loader's ``next()``), and per micro-batch
``evaluator.stage_wait`` (on a card, only when the host waits for a
staging slot's last upload to run), ``evaluator.pack`` (copying the
pending clips and their ids into the slot), ``evaluator.upload``
(enqueueing the slot's copy to the device), ``evaluator.describe``
(enqueueing the descriptor) and ``evaluator.accumulate`` (enqueueing the
per-tracklet sums); then ``evaluator.pool`` (the division by the clip
counts).

Under a data-parallel group (``mesh``, with ``evaluate(multihost=...)``)
each rank describes its contiguous stripe of each catalog
(``get_data(eval_stripe=True)``), and ``gather_striped_rows`` assembles
the features in catalog order on every rank. In eval mode a clip's
descriptor depends on no other clip, so the assembled features are those
of one process describing the whole catalog, which is also what grl_tpu's
one-process mesh gives. From there, on a group of more than one rank, the
tail is sharded as grl_tpu shards it (``evaluator.py:360-398``): each rank
computes its block of the distances (``parallel.sharded_cosine_distance``,
``rerank_columns``), re-ranking runs row-sharded over the group (the
min-plus kernel launches on every rank, over its rows of V), and each rank
scores its query rows of the result (``metrics.evaluate_device(mesh=)``).
Every rank returns the same rank-1, mAP and whole distance matrix. A
one-rank group runs the one-card tail.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..data.transforms import imagenet_stats, normalize
from ..parallel import gather_striped_rows, row_block, sharded_cosine_distance
from ..utils.profiling import span
from . import metrics
from .rerank import re_ranking, warn_if_degenerate
from .visualize import visualize_ranked_results


def cosine_distance(qf, gf):
    """Negative cosine similarity (features are L2-normalized)."""
    return -(qf @ gf.T)


def _euclidean(a, b):
    """Pairwise euclidean for the re-ranking inputs; clamps the squared
    distance at 1e-12 before the square root, as grl_tpu does."""
    sq = (a * a).sum(dim=1)[:, None] - 2.0 * (a @ b.T) + (b * b).sum(dim=1)[None, :]
    return sq.clamp(min=1e-12).sqrt()


def rerank_inputs(qf, gf, g_g=None):
    """Re-ranking's inputs as the box ``[q_g, q_q, g_g]`` for
    ``re_ranking(inputs_box=)``, which empties it so that they free once
    read (the staged builder relies on that); ``g_g`` passes a cached one.
    The reference's mix (grl_tpu ``evaluator.py:361``): q_g is the COSINE
    distance matrix while q_q and g_g are euclidean."""
    return [cosine_distance(qf, gf), _euclidean(qf, qf), _euclidean(gf, gf) if g_g is None else g_g]


def rerank_columns(qf, gf, mesh):
    """This rank's share of re-ranking's input under ``mesh``: the columns
    ``parallel.row_block(q + g, mesh)`` of ``c = [[q_q, q_g], [q_gᵀ, g_g]]``
    (q_g the cosine, q_q and g_g the euclidean distances of the Evaluator's
    re-ranking), transposed, as ``re_ranking(mesh=)`` takes them: a query
    column is q_q's column and q_g's row, a gallery column q_g's and
    g_g's columns."""
    q, g = qf.shape[0], gf.shape[0]
    start, stop, _ = row_block(q + g, mesh)
    out = torch.empty((stop - start, q + g), dtype=torch.float32, device=qf.device)
    a, b = min(start, q), min(stop, q)
    if b > a:
        out[: b - a, :q] = _euclidean(qf, qf[a:b]).T
        out[: b - a, q:] = sharded_cosine_distance(qf, gf, mesh, block=(a, b))
    c, d = max(start, q) - q, max(stop, q) - q
    if d > c:
        out[b - a :, :q] = sharded_cosine_distance(qf, gf, mesh, axis=1, block=(c, d)).T
        out[b - a :, q:] = _euclidean(gf, gf[c:d]).T
    return out


def make_descriptor_fn(cnn, siamese):
    """The 6144-d descriptor recipe: normalize -> CNN -> attention-pooled
    corr -> concat[x_uncorr, pooled, mean-over-t corr]. ``describe`` takes
    uint8 clips (b, t, h, w, 3) on the models' device. The descriptor is
    fp32 under any compute dtype: the pooled segment is an fp32 product, and
    the bf16 segments are promoted to it, as grl_tpu's concatenate does.
    The normalization's stats are made on a device at the first call there
    and kept: made anew, their copy from host memory would wait for the
    card to finish the work queued before each call."""
    stats = {}  # (channels, device) -> imagenet_stats

    def describe(clips_u8):
        key = (clips_u8.shape[-1], clips_u8.device)
        if key not in stats:
            stats[key] = imagenet_stats(*key)
        x_uncorr, x_corr = cnn(normalize(clips_u8, stats[key]))
        pooled = siamese.self_attention(x_corr)
        return torch.cat([x_uncorr.to(pooled.dtype), pooled, x_corr.mean(dim=1).to(pooled.dtype)], dim=1)

    return describe


def print_protocol(cmc_curve, mAP, cmc_topk=(1, 5, 10, 20)):
    print("Mean AP: {:4.1%}".format(mAP))
    for r in cmc_topk:
        if r <= len(cmc_curve):
            print("Rank-{:<3}: {:.1%}".format(r, cmc_curve[r - 1]))


def eval_items(query_loader, gallery_loader):
    """The ranked strips' item lists: the queries, and query ∪ gallery,
    which are the distance matrix's columns."""
    q_items = list(query_loader.dataset.tracklets)
    return q_items, q_items + list(gallery_loader.dataset.tracklets)


class EvalResult(NamedTuple):
    """What ``Evaluator.evaluate`` measured. ``distmat`` is the final (q, q+g)
    distance matrix (re-ranked when re-ranking is on); ``qf``/``gf`` are the
    query and query ∪ gallery features. The tensors stay on the device."""

    cmc: np.ndarray
    mAP: float
    distmat: torch.Tensor
    qf: torch.Tensor
    gf: torch.Tensor


class _Slot(NamedTuple):
    """One staging slot of the dense path (``Evaluator._staging``)."""

    clips: torch.Tensor
    ids: torch.Tensor
    device_clips: torch.Tensor
    device_ids: torch.Tensor
    uploaded: object  # a torch.cuda.Event on a card, else None


class Evaluator:
    def __init__(self, cnn, siamese, micro_batch=64, rerank=False, rerank_k1=20, rerank_k2=6,
                 rerank_lambda=0.3, save_distmat=None, visual_dir=None, device=None, mesh=None):
        """``save_distmat``: an .npz path that each ``evaluate`` writes the
        final distance matrix to, with the ids (grl_tpu's keys);
        ``visual_dir``: a directory that each ``evaluate`` writes the ranked
        strips of that matrix to; ``mesh``: a data-parallel group (the
        module docstring), whose device the evaluator runs on."""
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else mesh.device
        self.cnn = cnn.to(self.device).eval()
        self.siamese = siamese.to(self.device).eval()
        self.micro_batch = micro_batch
        self.rerank = rerank
        self.rerank_k1 = rerank_k1
        self.rerank_k2 = rerank_k2
        self.rerank_lambda = rerank_lambda
        self.save_distmat = save_distmat
        self.visual_dir = visual_dir
        self._describe = make_descriptor_fn(self.cnn, self.siamese)
        self._slots = None  # (key, the dense path's two staging slots): ``_staging``

    def _distances(self, qf, gf, mesh):
        """The final (q, q+g) distance matrix and the rows of it that this
        rank scores (all of them without ``mesh``): the cosine distances,
        re-ranked when re-ranking is on. Under ``mesh`` each rank computes
        its block and every rank gets the whole matrix."""
        if self.rerank:
            print("Applying person re-ranking ...")
            warn_if_degenerate(qf.shape[0] + gf.shape[0], self.rerank_k1, self.rerank_k2)
            kw = dict(k1=self.rerank_k1, k2=self.rerank_k2, lambda_value=self.rerank_lambda)
            if mesh is not None:
                distmat = re_ranking(inputs_box=[rerank_columns(qf, gf, mesh)], query_num=qf.shape[0],
                                     mesh=mesh, **kw)
                start, stop, _ = row_block(qf.shape[0], mesh)
                return distmat, distmat[start:stop]
            distmat = re_ranking(inputs_box=rerank_inputs(qf, gf), **kw)
            return distmat, distmat
        if mesh is None:
            distmat = cosine_distance(qf, gf)
            return distmat, distmat
        rows = sharded_cosine_distance(qf, gf, mesh)
        per = row_block(qf.shape[0], mesh)[2]
        padded = torch.cat([rows, rows.new_zeros((per - rows.shape[0], rows.shape[1]))])
        return gather_striped_rows(padded, qf.shape[0], mesh), rows

    def _to_device(self, clips_np):
        return torch.from_numpy(np.ascontiguousarray(clips_np)).to(self.device)

    def _bucket(self, size):
        """The descriptor shape a chunk of ``size`` clips is padded to, by
        grl_tpu's rule: the smallest of ``micro_batch // 3``,
        ``micro_batch // 2`` and ``micro_batch`` that holds it, so a 30-clip
        rrs_test batch at 96 pads to 32, not 96. grl_tpu rounds each bucket
        up to a multiple of its mesh's devices; one process drives one card
        here (under a group each rank describes its own stripe), so that
        multiple is 1."""
        mb = self.micro_batch
        for denom in (3, 2):
            if 0 < size <= mb // denom:
                return mb // denom
        return mb

    @torch.inference_mode()
    def describe_clips(self, clips_u8):
        """(n, S, h, w, C) uint8 clips -> a list of ``(descriptor rows
        (bucket, 3C) on the evaluator's device, valid row count)``, one per
        chunk of ``micro_batch`` clips (grl_tpu's ``describe_clips``). A
        chunk is padded with zero clips up to its ``_bucket``, on the
        device (the host copies only the valid clips); the padded rows
        follow the valid ones and are never read."""
        self.cnn.eval()
        self.siamese.eval()
        clips_u8 = np.asarray(clips_u8)
        outs = []
        for i in range(0, clips_u8.shape[0], self.micro_batch):
            chunk = self._to_device(clips_u8[i : i + self.micro_batch])
            size = chunk.shape[0]
            pad = self._bucket(size) - size
            if pad:
                chunk = torch.cat([chunk, chunk.new_zeros((pad, *chunk.shape[1:]))])
            outs.append((self._describe(chunk), size))
        return outs

    @torch.inference_mode()
    def extract_features(self, loader):
        """Loader -> (features (N, 3C) device tensor, pids, camids); dense
        tracklets are clip-averaged."""
        with span("evaluator.extract_features"):
            pids, camids = [], []
            # eval mode on every call: a training step between two evaluations
            # leaves the shared modules in train mode
            self.cnn.eval()
            self.siamese.eval()
            if loader.dataset.sample == "dense":
                feats = self._extract_dense(loader, len(loader.dataset), pids, camids)
            else:
                feats = self._extract_rows(loader, pids, camids)
            return feats, np.asarray(pids), np.asarray(camids)

    def _extract_rows(self, loader, pids, camids):
        rows = []
        for clips, pid, camid in loader:
            rows += [d[:size] for d, size in self.describe_clips(clips)]
            pids.extend(np.atleast_1d(pid).tolist())
            camids.extend(np.atleast_1d(camid).tolist())
        return torch.cat(rows)

    def _staging(self, clip_shape, dtype):
        """The dense path's two staging slots for micro-batches of clips of
        ``clip_shape`` and ``dtype``: made at the first micro-batch, kept
        across calls while the shape, the dtype and ``micro_batch`` hold.
        On a card a slot's host buffers are pinned, so its upload is an
        asynchronous copy into its device buffers, and ``uploaded`` is
        recorded once that copy is enqueued; on the CPU the host buffers
        are the device's and there is no event."""
        key = (self.micro_batch, tuple(clip_shape), dtype)
        if self._slots is None or self._slots[0] != key:
            self._slots = None  # frees the old buffers before the new ones are made
            cuda = self.device.type == "cuda"

            def slot():
                clips = torch.empty((self.micro_batch, *clip_shape), dtype=dtype, pin_memory=cuda)
                ids = torch.empty(self.micro_batch, dtype=torch.int64, pin_memory=cuda)
                if not cuda:
                    return _Slot(clips, ids, clips, ids, None)
                return _Slot(clips, ids, torch.empty_like(clips, device=self.device),
                             torch.empty_like(ids, device=self.device), torch.cuda.Event(blocking=True))

            self._slots = (key, (slot(), slot()))
        return self._slots[1]

    def _extract_dense(self, loader, n_items, pids, camids):
        """Clips of many tracklets packed into micro-batches of
        ``micro_batch`` in loader order, each described and added into its
        tracklets' sums. A micro-batch is copied once, into the next of two
        staging slots (``_staging``); on a card the host then fills the
        other slot while the card describes this one. It waits for the
        card before refilling a slot whose upload has not run yet, and
        otherwise only where the card's queue of launched work is full."""
        mb = self.micro_batch
        buf = None
        counts = np.zeros(n_items, np.float32)
        pend, pending = collections.deque(), 0  # [clips not yet staged, item]
        slots, turn = None, 0
        item = 0

        def flush(n):
            nonlocal buf, turn
            slot = slots[turn]
            turn = 1 - turn
            if slot.uploaded is not None and not slot.uploaded.query():
                with span("evaluator.stage_wait"):
                    slot.uploaded.synchronize()
            with span("evaluator.pack"):
                row = 0
                while row < n:
                    clips, owner = pend[0]
                    k = min(clips.shape[0], n - row)
                    slot.clips[row : row + k].copy_(clips[:k])
                    slot.ids[row : row + k] = owner
                    if k == clips.shape[0]:
                        pend.popleft()
                    else:
                        pend[0][0] = clips[k:]
                    row += k
            with span("evaluator.upload"):
                chunk, ids = slot.device_clips[:n], slot.device_ids[:n]
                if slot.uploaded is not None:
                    chunk.copy_(slot.clips[:n], non_blocking=True)
                    ids.copy_(slot.ids[:n], non_blocking=True)
                    slot.uploaded.record()
            with span("evaluator.describe"):
                d = self._describe(chunk)
            with span("evaluator.accumulate"):
                if buf is None:
                    buf = torch.zeros((n_items, d.shape[1]), dtype=d.dtype, device=self.device)
                buf.index_add_(0, ids, d)

        it = iter(loader)
        while True:
            with span("evaluator.loader_wait"):
                batch = next(it, None)
            if batch is None:
                break
            clips, pid, camid = batch
            clips = torch.from_numpy(np.ascontiguousarray(clips))
            if slots is None:
                slots = self._staging(clips.shape[1:], clips.dtype)
            counts[item] = clips.shape[0]
            pend.append([clips, item])
            pending += clips.shape[0]
            pids.extend(np.atleast_1d(pid).tolist())
            camids.extend(np.atleast_1d(camid).tolist())
            item += 1
            while pending >= mb:
                flush(mb)
                pending -= mb
        if pending:
            flush(pending)
        if item != n_items:
            raise RuntimeError(f"extracted {item} tracklets, expected {n_items}")
        with span("evaluator.pool"):
            return buf / torch.from_numpy(counts).to(self.device)[:, None]

    @torch.inference_mode()
    def evaluate(self, query_loader, gallery_loader, cmc_topk=(1, 5, 10, 20), multihost=None):
        """Full retrieval protocol; prints the reference-format report and
        returns an :class:`EvalResult`.

        ``multihost``: ``{"query": (n_total, pids, camids), "gallery": ...}``
        of the whole catalogs (``parallel.eval_catalog_meta``), when the
        loaders hold this rank's stripe (``parallel.stripe_catalog``); needs
        ``mesh``."""
        if multihost is not None and self.mesh is None:
            raise ValueError("multihost evaluation requires a mesh")
        t0 = time.time()

        def fetch(loader, split):
            feats, pids, camids = self.extract_features(loader)
            if multihost is None:
                return feats, pids, camids
            n_total, pids, camids = multihost[split]
            return gather_striped_rows(feats, n_total, self.mesh), np.asarray(pids), np.asarray(camids)

        qf, q_pids, q_camids = fetch(query_loader, "query")
        print(f"Done, obtained {qf.shape[0]}-by-{qf.shape[1]} matrix")
        gf, g_pids, g_camids = fetch(gallery_loader, "gallery")
        # the gallery includes the queries, as the reference protocol has it
        gf = torch.cat([qf, gf])
        g_pids = np.append(q_pids, g_pids)
        g_camids = np.append(q_camids, g_camids)
        print(f"Done, obtained {gf.shape[0]}-by-{gf.shape[1]} matrix")

        print("Computing distance matrix")
        mesh = self.mesh if self.mesh is not None and self.mesh.size > 1 else None
        distmat, rows = self._distances(qf, gf, mesh)

        if self.save_distmat and multihost is not None:
            print("--save-distmat skipped under multi-host; re-run on one process to save it")
        elif self.save_distmat:
            np.savez(self.save_distmat, distmat=distmat.cpu().numpy(), q_pids=q_pids,
                     q_camids=q_camids, g_pids=g_pids, g_camids=g_camids, rerank=np.bool_(self.rerank))
            print(f"saved distance matrix to {self.save_distmat}")

        cmc_curve, mAP = metrics.evaluate_device(rows, q_pids, g_pids, q_camids, g_camids, mesh=mesh)
        print_protocol(cmc_curve, mAP, cmc_topk)
        print("------------------")
        if self.visual_dir and multihost is not None:
            # each rank's loaders hold only its stripe of the catalogs
            print("visualizations skipped under multi-host; re-run on one process for --visual")
        elif self.visual_dir:
            q_items, g_items = eval_items(query_loader, gallery_loader)
            visualize_ranked_results(distmat.cpu().numpy(), q_items, g_items, self.visual_dir)
            print(f"saved ranked visualizations to {self.visual_dir}")
        print(f"(evaluation took {time.time() - t0:.1f}s)")
        return EvalResult(cmc_curve, mAP, distmat, qf, gf)
