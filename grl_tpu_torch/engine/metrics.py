"""Retrieval metrics (counterpart of ``grl_tpu/engine/metrics.py``).

The MARS protocol: argsort each distance row, drop gallery entries sharing
the query's pid AND camera, CMC from the first remaining hit, AP from
cumulative precision at hits, vectorized over all queries. ``evaluate``
is the host numpy form, ``evaluate_device`` the same protocol on the
distance matrix's device; both sort stably, so exact ties order by
gallery index and the two agree even on tie-heavy distances.

The open-reid functions ``cmc``, ``mean_ap`` and ``accuracy`` and the
Market-1501 protocol ``evaluate_market`` are grl_tpu's host numpy
functions (``:167-318``), their quirks included.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..parallel import row_block


def _sorted_masks(distmat, query_ids, gallery_ids, query_cams, gallery_cams):
    """Stable argsort of each row, the sorted pid matches, and the mask of
    entries that are not junk (same pid and same camera)."""
    indices = np.argsort(distmat, axis=1, kind="stable")
    matches = gallery_ids[indices] == query_ids[:, None]
    junk = matches & (gallery_cams[indices] == query_cams[:, None])
    return indices, matches, ~junk


def evaluate(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=100):
    """Host numpy protocol. Returns (cmc_curve[max_rank], mAP) over queries
    with at least one valid (junk-removed) gallery match."""
    distmat = np.asarray(distmat)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    max_rank = min(max_rank, distmat.shape[1])

    _, matches, keep = _sorted_masks(distmat, q_pids, g_pids, q_camids, g_camids)
    kept_matches = matches & keep
    valid = kept_matches.any(axis=1)
    if not valid.any():
        raise RuntimeError("Error: all query identities do not appear in gallery")

    # rank of each sorted column among kept entries for its query
    pos = np.cumsum(keep, axis=1) - 1
    first_hit = np.where(kept_matches, pos, np.iinfo(np.int64).max).min(axis=1)
    cmc_curve = (first_hit[valid][:, None] <= np.arange(max_rank)[None, :]).mean(axis=0)

    cum_hits = np.cumsum(kept_matches, axis=1)
    precision = np.where(kept_matches, cum_hits / np.maximum(pos + 1.0, 1.0), 0.0)
    ap = precision.sum(axis=1)[valid] / kept_matches.sum(axis=1)[valid]
    return cmc_curve.astype(np.float32), float(ap.mean())


def evaluate_device(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=100, mesh=None):
    """The same protocol on ``distmat``'s device (a torch tensor): only the
    CMC curve and the mAP scalar come back to the host.

    With ``mesh`` (a ``parallel.Mesh``) the query rows are sharded over the
    group, as grl_tpu's ``mesh=``: ``distmat`` is this rank's rows
    ``parallel.row_block(q, mesh)`` of the (q, g) matrix, the ids are all
    q queries'. Each rank scores its rows, padded to the block's height
    with zero-distance rows whose pid is a sentinel below every real pid
    (grl_tpu's; a constant -1 would match a junk pid -1 and fabricate
    rank-1 hits), and the CMC hit counts, AP sums and valid counts are
    summed over the ranks. Every rank returns the whole result."""
    dev = distmat.device
    as_dev = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    if mesh is not None:
        q_pids, q_camids, g_pids = np.asarray(q_pids), np.asarray(q_camids), np.asarray(g_pids)
        start, stop, per = row_block(len(q_pids), mesh)
        if distmat.shape[0] != stop - start:
            raise ValueError(f"rank {mesh.rank} holds {distmat.shape[0]} query rows; row_block gives "
                             f"[{start}, {stop})")
        pad = per - (stop - start)
        sentinel = int(min(q_pids.min(), g_pids.min())) - 1
        distmat = torch.cat([distmat, distmat.new_zeros((pad, distmat.shape[1]))])
        q_pids = np.concatenate([q_pids[start:stop], np.full(pad, sentinel, q_pids.dtype)])
        q_camids = np.concatenate([q_camids[start:stop], np.full(pad, -1, q_camids.dtype)])
    q_pids, g_pids, q_camids, g_camids = map(as_dev, (q_pids, g_pids, q_camids, g_camids))
    max_rank = min(max_rank, distmat.shape[1])

    indices = torch.argsort(distmat, dim=1, stable=True)
    matches = g_pids[indices] == q_pids[:, None]
    keep = ~(matches & (g_camids[indices] == q_camids[:, None]))
    kept = matches & keep
    valid = kept.any(dim=1)
    pos = torch.cumsum(keep, dim=1) - 1
    first_hit = torch.where(kept, pos, torch.iinfo(pos.dtype).max).min(dim=1).values
    hits = ((first_hit[:, None] <= torch.arange(max_rank, device=dev)[None, :]) & valid[:, None]).sum(dim=0)
    cum_hits = torch.cumsum(kept, dim=1).to(torch.float64)
    precision = torch.where(kept, cum_hits / (pos + 1).clamp(min=1), 0.0)
    ap = precision.sum(dim=1) / kept.sum(dim=1).clamp(min=1)
    ap_sum = torch.where(valid, ap, 0.0).sum()
    nvalid = valid.sum()
    if mesh is not None:
        sums = torch.cat([hits.to(torch.float64), ap_sum[None], nvalid[None].to(torch.float64)])
        dist.all_reduce(sums)
        hits, ap_sum, nvalid = sums[:max_rank], sums[max_rank], sums[max_rank + 1]
    if not bool(nvalid > 0):
        raise RuntimeError("Error: all query identities do not appear in gallery")
    nvalid = nvalid.to(torch.float64)
    cmc_curve = hits / nvalid
    mAP = ap_sum / nvalid
    return cmc_curve.to(torch.float32).cpu().numpy(), float(mAP)


def _default_ids(distmat, query_ids, gallery_ids, query_cams, gallery_cams):
    m, n = distmat.shape
    return (np.arange(m) if query_ids is None else np.asarray(query_ids),
            np.arange(n) if gallery_ids is None else np.asarray(gallery_ids),
            np.zeros(m, np.int32) if query_cams is None else np.asarray(query_cams),
            np.ones(n, np.int32) if gallery_cams is None else np.asarray(gallery_cams))


def cmc(distmat, query_ids=None, gallery_ids=None, query_cams=None, gallery_cams=None, topk=100,
        separate_camera_set=False, single_gallery_shot=False, first_match_break=False, seed=None):
    """Open-reid CMC: junk removal keeps entries with a different pid OR a
    different camera; the allshots, cuhk03 (``single_gallery_shot``, ten
    draws of one entry per gallery id from ``RandomState(seed)``) and
    market1501 (``first_match_break``) configurations. Ranks count within
    the junk-compressed order."""
    distmat = np.asarray(distmat)
    query_ids, gallery_ids, query_cams, gallery_cams = _default_ids(
        distmat, query_ids, gallery_ids, query_cams, gallery_cams)
    rng = np.random.RandomState(seed)

    indices, matches, keep = _sorted_masks(distmat, query_ids, gallery_ids, query_cams, gallery_cams)
    if separate_camera_set:
        keep &= gallery_cams[indices] != query_cams[:, None]

    ret = np.zeros(topk)
    num_valid = 0
    for i in range(distmat.shape[0]):
        valid = keep[i]
        if not np.any(matches[i] & valid):
            continue
        repeat = 1
        if single_gallery_shot:
            repeat = 10
            groups = {}
            for j, x in zip(np.where(valid)[0], gallery_ids[indices[i][valid]]):
                groups.setdefault(x, []).append(j)
        for _ in range(repeat):
            if single_gallery_shot:
                sampled = np.zeros(len(valid), dtype=bool)
                for js in groups.values():
                    sampled[rng.choice(js)] = True
                index = np.nonzero(matches[i][sampled])[0]
            else:
                index = np.nonzero(matches[i][valid])[0]
            delta = 1.0 / (len(index) * repeat)
            for j, k in enumerate(index):
                if k - j >= topk:
                    break
                if first_match_break:
                    ret[k - j] += 1
                    break
                ret[k - j] += delta
        num_valid += 1
    if num_valid == 0:
        raise RuntimeError("No valid query")
    return ret.cumsum() / num_valid


def mean_ap(distmat, query_ids=None, gallery_ids=None, query_cams=None, gallery_cams=None):
    """Open-reid mAP: the interpolation-free precision average at each kept
    hit, over queries with at least one."""
    distmat = np.asarray(distmat)
    query_ids, gallery_ids, query_cams, gallery_cams = _default_ids(
        distmat, query_ids, gallery_ids, query_cams, gallery_cams)
    _, matches, keep = _sorted_masks(distmat, query_ids, gallery_ids, query_cams, gallery_cams)
    kept = matches & keep
    valid = kept.any(axis=1)
    if not valid.any():
        raise RuntimeError("No valid query")
    pos = np.cumsum(keep, axis=1) - 1
    precision = np.where(kept, np.cumsum(kept, axis=1) / np.maximum(pos + 1.0, 1.0), 0.0)
    return float((precision.sum(axis=1)[valid] / kept.sum(axis=1)[valid]).mean())


def accuracy(output, target, topk=(1,)):
    """Top-k accuracy of logits ``output`` (n, classes) against ``target`` (n,)."""
    output, target = np.asarray(output), np.asarray(target)
    correct = np.argsort(-output, axis=1)[:, :max(topk)] == target[:, None]
    return [float(correct[:, :k].any(axis=1).mean()) for k in topk]


def evaluate_market(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=100):
    """Market-1501 protocol: good = same pid, other camera; junk = pid -1 or
    same pid and camera; AP is the trapezoidal precision-recall integral
    over the junk-compressed ranking. grl_tpu's quirks kept: each row's
    order is cut to ``max_rank`` before junk is skipped (a hit ranked
    further counts in neither CMC nor AP), and mAP averages over all
    queries, those with no good match too."""
    distmat = np.asarray(distmat)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    num_q = distmat.shape[0]
    cmc_rows = np.zeros((num_q, max_rank), np.float32)
    aps = np.zeros(num_q, np.float32)
    num_valid = 0
    for k in range(num_q):
        good = (q_pids[k] == g_pids) & (q_camids[k] != g_camids)
        if not good.any():
            continue
        num_valid += 1
        junk = (g_pids == -1) | ((q_pids[k] == g_pids) & (q_camids[k] == g_camids))
        num_real = int(good.sum())
        old_recall, old_precision, ap = 0.0, 1.0, 0.0
        intersect, j, njunk, good_now = 0, 0, 0, 0
        for n, gi in enumerate(np.argsort(distmat[k])[:max_rank]):
            hit = bool(good[gi])
            if hit:
                cmc_rows[k, n - njunk:] = 1
                good_now += 1
            if junk[gi]:
                njunk += 1
                continue
            intersect += hit
            recall, precision = intersect / num_real, intersect / (j + 1)
            ap += (recall - old_recall) * (old_precision + precision) / 2
            old_recall, old_precision = recall, precision
            j += 1
            if good_now == num_real:
                break
        aps[k] = ap
    if num_valid == 0:
        raise RuntimeError("No valid query")
    return cmc_rows.sum(0) / num_valid, float(aps.mean())
