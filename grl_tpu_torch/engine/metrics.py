"""MARS-protocol CMC + mAP (counterpart of
``grl_tpu/engine/metrics.py:20-164``).

Argsort each distance row, drop gallery entries sharing the query's pid
AND camera, CMC from the first remaining hit, AP from cumulative
precision at hits — vectorized over all queries. ``evaluate`` is the host
numpy form, ``evaluate_device`` the same protocol on the distance
matrix's device; both sort stably, so exact ties order by gallery index
and the two agree even on tie-heavy distances.
"""

from __future__ import annotations

import numpy as np
import torch


def evaluate(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=100):
    """Host numpy protocol. Returns (cmc_curve[max_rank], mAP) over queries
    with at least one valid (junk-removed) gallery match."""
    distmat = np.asarray(distmat)
    q_pids, g_pids = np.asarray(q_pids), np.asarray(g_pids)
    q_camids, g_camids = np.asarray(q_camids), np.asarray(g_camids)
    max_rank = min(max_rank, distmat.shape[1])

    indices = np.argsort(distmat, axis=1, kind="stable")
    matches = g_pids[indices] == q_pids[:, None]
    keep = ~(matches & (g_camids[indices] == q_camids[:, None]))
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


def evaluate_device(distmat, q_pids, g_pids, q_camids, g_camids, max_rank=100):
    """The same protocol on ``distmat``'s device (a torch tensor): only the
    CMC curve and the mAP scalar come back to the host."""
    dev = distmat.device
    as_dev = lambda x: torch.as_tensor(np.asarray(x), device=dev)
    q_pids, g_pids, q_camids, g_camids = map(as_dev, (q_pids, g_pids, q_camids, g_camids))
    max_rank = min(max_rank, distmat.shape[1])

    indices = torch.argsort(distmat, dim=1, stable=True)
    matches = g_pids[indices] == q_pids[:, None]
    keep = ~(matches & (g_camids[indices] == q_camids[:, None]))
    kept = matches & keep
    valid = kept.any(dim=1)
    if not bool(valid.any()):
        raise RuntimeError("Error: all query identities do not appear in gallery")
    nvalid = valid.sum().to(torch.float64)

    pos = torch.cumsum(keep, dim=1) - 1
    first_hit = torch.where(kept, pos, torch.iinfo(pos.dtype).max).min(dim=1).values
    hits = (first_hit[:, None] <= torch.arange(max_rank, device=dev)[None, :]) & valid[:, None]
    cmc_curve = hits.sum(dim=0) / nvalid

    cum_hits = torch.cumsum(kept, dim=1).to(torch.float64)
    precision = torch.where(kept, cum_hits / (pos + 1).clamp(min=1), 0.0)
    ap = precision.sum(dim=1) / kept.sum(dim=1).clamp(min=1)
    mAP = torch.where(valid, ap, 0.0).sum() / nvalid
    return cmc_curve.to(torch.float32).cpu().numpy(), float(mAP)
