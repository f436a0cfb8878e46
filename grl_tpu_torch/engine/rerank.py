"""k-reciprocal re-ranking (Zhong et al., CVPR 2017) on the device.

Counterpart of grl_tpu's one-program device path (``re_ranking_device``
with ``_make_build_v``/``_v_from_original``, ``grl_tpu/engine/rerank.py:
51-232, 688-756``), which is the path MARS-scale galleries take
(n = 1980 + 11310 = 13290 is below its staged-builder cut at n > 16384).

Definitions (n = #query + #gallery, D = column-normalized squared dist):
- A[i, j]      = j among i's k1+1 nearest (incl. self)
- R = A ∧ Aᵀ   : k-reciprocal sets
- B            : same with ⌊k1/2⌋-neighborhoods
- expansion: R'(i) = R(i) ∪ { B(c) : c ∈ R(i), |B(c) ∩ R(i)| > ⅔|B(c)| }
- V[i]         = exp(-D[i]) masked to R'(i), row-normalized
- query expansion: V ← mean of V over each row's k2 nearest
- Jaccard dist = 1 − Σ_k min(V[i,k], V[j,k]) / (2 − Σ_k min(...))
- final = (1−λ)·Jaccard + λ·D[:q]

The Jaccard min-sum is the hand-written min-plus kernel (``ops.minplus``).
The staged large-n builder, the capacity-padded serving builder and the
host numpy form come with later slices.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import minplus, padded_empty


def warn_if_degenerate(n_total, k1=20, k2=6):
    """Warn (on stderr) when the (query+gallery) count is small relative to
    the neighborhood sizes: at n ≲ 2·(k1+1) the k-reciprocal sets cover most
    of the gallery and re-ranking degrades an otherwise-correct ranking."""
    if n_total < 2 * (k1 + 1):
        print(
            f"WARNING: re-ranking a {n_total}-item query∪gallery with "
            f"k1={k1}, k2={k2}: k-reciprocal neighborhoods cover most of "
            "the set at this scale and typically DEGRADE the ranking; "
            "use --rerank only at realistic gallery sizes (or lower k1/k2)",
            file=sys.stderr,
        )
        return True
    return False


def nearest(original):
    """Every row's columns from nearest to farthest, ties by lower index.

    A stable ascending argsort orders exactly as ``jax.lax.top_k(-x, k)``
    does (largest of -x first, ties to the lower index); ``torch.topk``
    breaks ties in no fixed order."""
    return torch.argsort(original, dim=1, stable=True)


def v_from_original(original, k1, k2):
    """Normalized distance matrix (n, n) -> membership-weight matrix V, in
    rows padded to 16 bytes (``ops.padded_empty``) so the min-plus kernel
    reads V and its query rows without a copy."""
    n = original.shape[0]
    order = nearest(original)

    def topk_adj(k):
        # numpy's rank[:, :k] clamps when k > n; so does grl_tpu
        adj = torch.zeros((n, n), dtype=torch.bool, device=original.device)
        return adj.scatter_(1, order[:, : min(k, n)], True)

    reciprocal = topk_adj(k1 + 1)
    reciprocal = reciprocal & reciprocal.T

    half = int(np.around(k1 / 2.0)) + 1
    b = topk_adj(half)
    b = b & b.T
    b_sizes = b.sum(dim=1).to(torch.float32)

    # 0/1 operands: every count is an integer ≤ k1+1, exact in bf16
    rf = reciprocal.to(torch.bfloat16)
    bf = b.to(torch.bfloat16)
    overlap = (rf @ bf.T).to(torch.float32)
    qualifies = reciprocal & (overlap > (2.0 / 3.0) * b_sizes[None, :])
    expanded = qualifies.to(torch.bfloat16) @ bf
    expansion = reciprocal | (expanded > 0)

    weights = torch.exp(-original) * expansion
    if k2 == 1:
        return torch.div(weights, weights.sum(dim=1, keepdim=True), out=padded_empty(n, n, weights.device))
    v = weights / weights.sum(dim=1, keepdim=True)
    del weights  # each n x n temporary freed as soon as it is spent
    idx2 = order[:, : min(k2, n)]
    last = idx2.shape[1] - 1
    # summed in grl_tpu's order; an out-of-range column clamps as JAX's
    # gather does (n < k2 only on toy sets)
    acc = v[idx2[:, 0]]
    for j in range(1, k2):
        acc = acc + v[idx2[:, min(j, last)]]
    del v
    return torch.div(acc, k2, out=padded_empty(n, n, acc.device))


def re_ranking(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6, lambda_value=0.3, min_sum_fn=minplus):
    """Re-ranked (q, g) distance matrix from the three distance matrices,
    computed on their device. ``min_sum_fn`` is the Jaccard min-sum: the
    min-plus kernel wrapper, or ``ops.minplus_plain`` to check it."""
    query_num = q_g_dist.shape[0]
    gallery_num = g_g_dist.shape[0]
    original = torch.cat(
        [torch.cat([q_q_dist, q_g_dist], dim=1), torch.cat([q_g_dist.T, g_g_dist], dim=1)],
        dim=0,
    )
    original = original.square().to(torch.float32)
    original = (original / original.max(dim=0).values).T.contiguous()
    v = v_from_original(original, k1, k2)
    min_sum = min_sum_fn(v[:query_num], v)
    del v
    jaccard = 1.0 - min_sum / (2.0 - min_sum)
    final = jaccard * (1 - lambda_value) + original[:query_num] * lambda_value
    return final[:, query_num : query_num + gallery_num]
