"""Retrieval evaluator: descriptor extraction + cosine ranking + CMC/mAP
(counterpart of ``grl_tpu/engine/evaluator.py``).

- descriptor per clip = concat(x_uncorr, attention-pooled x_corr, temporal
  mean of x_corr) -> 3·C dims (6144 for ResNet-50);
- dense path: every consecutive clip of a tracklet is described and the
  descriptors averaged; clips of many tracklets are packed into each
  micro-batch and added into per-tracklet sums on the device;
- rrs_test path: one clip per tracklet, rows written in order;
- gallery := query ∪ gallery, cosine distance ``-qf @ gfᵀ``, optional
  k-reciprocal re-ranking on the device (with the min-plus kernel; the
  staged builder above n = 16384 items, as grl_tpu), and the
  MARS protocol on the device; ``save_distmat`` writes the final distance
  matrix and ids to an npz with grl_tpu's keys, and ``visual_dir`` gets
  the ranked strips of that matrix (``engine/visualize.py``).

Features and distance matrices stay on the device; only the CMC curve and
mAP come back to the host.

Under a data-parallel group (``mesh``, with ``evaluate(multihost=...)``)
each rank describes its contiguous stripe of each catalog
(``get_data(eval_stripe=True)``), and ``gather_striped_rows`` assembles
the features in catalog order on every rank. In eval mode a clip's
descriptor depends on no other clip, so the assembled features are those
of one process describing the whole catalog, which is also what grl_tpu's
one-process mesh gives. From there every rank runs the one-card path on
the whole features: the distances, re-ranking (the min-plus kernel
launches once per rank; grl_tpu row-shards it, which only adds memory past
one card) and the protocol. Every rank returns the same rank-1 and mAP.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..data.transforms import normalize
from ..parallel import gather_striped_rows
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


def make_descriptor_fn(cnn, siamese):
    """The 6144-d descriptor recipe: normalize -> CNN -> attention-pooled
    corr -> concat[x_uncorr, pooled, mean-over-t corr]. ``describe`` takes
    uint8 clips (b, t, h, w, 3) on the models' device. The descriptor is
    fp32 under any compute dtype: the pooled segment is an fp32 product, and
    the bf16 segments are promoted to it, as grl_tpu's concatenate does."""

    def describe(clips_u8):
        x_uncorr, x_corr = cnn(normalize(clips_u8))
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

    def _to_device(self, clips_np):
        return torch.from_numpy(np.ascontiguousarray(clips_np)).to(self.device)

    @torch.inference_mode()
    def extract_features(self, loader):
        """Loader -> (features (N, 3C) device tensor, pids, camids); dense
        tracklets are clip-averaged."""
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
            for i in range(0, clips.shape[0], self.micro_batch):
                rows.append(self._describe(self._to_device(clips[i : i + self.micro_batch])))
            pids.extend(np.atleast_1d(pid).tolist())
            camids.extend(np.atleast_1d(camid).tolist())
        return torch.cat(rows)

    def _extract_dense(self, loader, n_items, pids, camids):
        mb = self.micro_batch
        buf = None
        counts = np.zeros(n_items, np.float32)
        pend_clips, pend_ids, pending = [], [], 0
        item = 0

        def flush(clips_np, ids_np):
            nonlocal buf
            d = self._describe(self._to_device(clips_np))
            if buf is None:
                buf = torch.zeros((n_items, d.shape[1]), dtype=d.dtype, device=self.device)
            buf.index_add_(0, torch.from_numpy(ids_np).to(self.device), d)

        for clips, pid, camid in loader:
            n_clips = clips.shape[0]
            counts[item] = n_clips
            pend_clips.append(clips)
            pend_ids.append(np.full(n_clips, item, np.int64))
            pending += n_clips
            pids.extend(np.atleast_1d(pid).tolist())
            camids.extend(np.atleast_1d(camid).tolist())
            item += 1
            while pending >= mb:
                clips_np = np.concatenate(pend_clips)
                ids_np = np.concatenate(pend_ids)
                flush(clips_np[:mb], ids_np[:mb])
                pend_clips, pend_ids = [clips_np[mb:]], [ids_np[mb:]]
                pending -= mb
        if pending:
            flush(np.concatenate(pend_clips), np.concatenate(pend_ids))
        if item != n_items:
            raise RuntimeError(f"extracted {item} tracklets, expected {n_items}")
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
        distmat = cosine_distance(qf, gf)
        if self.rerank:
            print("Applying person re-ranking ...")
            warn_if_degenerate(qf.shape[0] + gf.shape[0], self.rerank_k1, self.rerank_k2)
            # the reference's inputs: q_g is the COSINE distance matrix while
            # q_q and g_g are euclidean. Handed over in a box that re_ranking
            # empties, so the three matrices free once its builder has read
            # them (the staged builder, above n = 16384, relies on that)
            box = [distmat, _euclidean(qf, qf), _euclidean(gf, gf)]
            distmat = None
            distmat = re_ranking(
                inputs_box=box,
                k1=self.rerank_k1, k2=self.rerank_k2, lambda_value=self.rerank_lambda,
            )

        if self.save_distmat and multihost is not None:
            print("--save-distmat skipped under multi-host; re-run on one process to save it")
        elif self.save_distmat:
            np.savez(self.save_distmat, distmat=distmat.cpu().numpy(), q_pids=q_pids,
                     q_camids=q_camids, g_pids=g_pids, g_camids=g_camids, rerank=np.bool_(self.rerank))
            print(f"saved distance matrix to {self.save_distmat}")

        cmc_curve, mAP = metrics.evaluate_device(distmat, q_pids, g_pids, q_camids, g_camids)
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
