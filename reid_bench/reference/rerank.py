"""k-reciprocal re-ranking (Zhong et al., CVPR 2017) in plain PyTorch, as
the GRL reference calls it (``re_ranking(q_g, q_q, g_g, k1, k2, lambda)``
of reid/evaluator and utils/re_ranking.py): the cosine distance between
queries and gallery, euclidean distances within each set.

The reference's loops become whole-matrix operations with the same
meaning: ``R[i, j]`` says j is among i's k1 + 1 nearest and i among j's;
``H`` the same at ``round(k1 / 2) + 1``; a candidate c of ``R[i]``
expands i's set by ``H[c]`` when more than two thirds of ``H[c]`` lies in
``R[i]``; V's rows hold ``exp(-d)`` over the expanded set, normalized,
then averaged over each row's k2 nearest rows; the Jaccard distance of
query i and item j is ``1 - m / (2 - m)`` with ``m = sum_t min(V[i, t],
V[j, t])``, and the result blends it with the normalized distance. Ties
in the nearest-neighbour order go to the lower index (a stable sort).
``precision`` rounds the operands of the distance products as
``reference.grl.round_operand`` does; the 0/1 products count exactly.
"""

from __future__ import annotations

import torch

from .grl import round_operand


def _euclidean(a, b, precision):
    ra, rb = round_operand(a, precision), round_operand(b, precision)
    sq = (a * a).sum(dim=1)[:, None] - 2.0 * (ra @ rb.T) + (b * b).sum(dim=1)[None, :]
    return sq.clamp(min=1e-12).sqrt()


def _adjacency(order, k):
    n = order.shape[0]
    adj = torch.zeros((n, n), dtype=torch.bool, device=order.device)
    return adj.scatter_(1, order[:, : min(k, n)], True)


@torch.no_grad()
def rerank(qf, gf, k1=20, k2=6, lambda_value=0.3, precision="fp32", block=1024):
    """Queries ``qf`` (q, d) against gallery ``gf`` (g, d) -> re-ranked
    distances (q, g)."""
    q = qf.shape[0]
    q_g = -(round_operand(qf, precision) @ round_operand(gf, precision).T)
    original = torch.cat([torch.cat([_euclidean(qf, qf, precision), q_g], dim=1),
                          torch.cat([q_g.T, _euclidean(gf, gf, precision)], dim=1)])
    del q_g
    original = original.square()
    original = (original / original.max(dim=0).values).T.contiguous()
    order = torch.argsort(original, dim=1, stable=True)

    r = _adjacency(order, k1 + 1)
    r = r & r.T
    h = _adjacency(order, round(k1 / 2.0) + 1)
    h = h & h.T
    rf, hf = r.float(), h.float()
    overlap = rf @ hf.T  # |R[i] ∩ H[c]|
    qualifies = r & (overlap > (2.0 / 3.0) * hf.sum(dim=1)[None, :])
    del overlap
    expanded = r | ((qualifies.float() @ hf) > 0)
    del rf, hf, qualifies, r, h
    weights = torch.exp(-original) * expanded
    v = weights / weights.sum(dim=1, keepdim=True)
    del weights, expanded
    if k2 != 1:
        v = _qe(v, order, k2)
    out = torch.empty((q, v.shape[0]), dtype=v.dtype, device=v.device)
    for i in range(q):
        out[i] = torch.cat([torch.minimum(v[i][None, :], v[j : j + block]).sum(dim=1)
                            for j in range(0, v.shape[0], block)])
    jaccard = 1.0 - out / (2.0 - out)
    final = jaccard * (1.0 - lambda_value) + original[:q] * lambda_value
    return final[:, q:]


def _qe(v, order, k2):
    """Each row of V averaged over its k2 nearest rows, summed in order."""
    acc = v[order[:, 0]]
    for j in range(1, k2):
        acc += v[order[:, j]]
    return acc / k2
