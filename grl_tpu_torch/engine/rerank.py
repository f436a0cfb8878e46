"""k-reciprocal re-ranking (Zhong et al., CVPR 2017).

Counterpart of ``grl_tpu/engine/rerank.py``. Definitions (n = #query +
#gallery, D = column-normalized squared dist):
- A[i, j]      = j among i's k1+1 nearest (incl. self)
- R = A ∧ Aᵀ   : k-reciprocal sets
- B            : same with ⌊k1/2⌋-neighborhoods
- expansion: R'(i) = R(i) ∪ { B(c) : c ∈ R(i), |B(c) ∩ R(i)| > ⅔|B(c)| }
- V[i]         = exp(-D[i]) masked to R'(i), row-normalized
- query expansion: V ← mean of V over each row's k2 nearest
- Jaccard dist = 1 − Σ_k min(V[i,k], V[j,k]) / (2 − Σ_k min(...))
- final = (1−λ)·Jaccard + λ·D[:q]

Four builders, as in grl_tpu:
- ``re_ranking`` (``re_ranking_device``): the one-program path
  (``v_from_original``) up to n = 16384, the staged memory-lean builder
  (``_build_v_staged``) above it or when ``valid`` counts are given;
- ``re_ranking_padded`` (``re_ranking_device_padded``): one program over
  capacity-padded inputs, the serve daemon's route;
- ``re_ranking_host`` (grl_tpu's host ``re_ranking``): numpy, a copy.

Every device builder ends in the Jaccard min-sum, the hand-written min-plus
kernel (``ops.minplus``), over V built in 16-byte aligned rows
(``ops.padded_empty``) so the kernel reads it in place.

Not carried over: grl_tpu's caches of compiled stage programs
(``_STAGED_CACHE``, ``_BUILD_V_CACHE``, ``_PADDED_RERANK_CACHE``), since
torch has nothing to compile, and the host-read barriers of its staged
builder (``sync``), whose job the caching allocator's stream-ordered frees
already do. The ``mesh`` row-sharding waits for multi-card support.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import minplus, padded_empty

# B-row slab width of the deferred min-plus loop; row-block width of the
# staged stages. Module constants so tests can shrink them and run the
# multi-slab and ragged-block paths at toy sizes.
_MINPLUS_CHUNK = 8192
_STAGE_BLOCK = 4096


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


def top_k(x, k):
    """``(values, indices)`` of each row's ``k`` largest entries of float32
    ``x``, in ``jax.lax.top_k``'s order: IEEE total order (+0.0 above -0.0)
    and ties to the lower index. The sort runs on integer keys that order
    as the floats' total order."""
    bits = x.view(torch.int32)
    keys = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(keys, dim=1, descending=True, stable=True).indices[:, :k]
    return x.gather(1, idx), idx


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


def _jaccard_blend(min_sum, original_q, lambda_value):
    jaccard = 1.0 - min_sum / (2.0 - min_sum)
    return jaccard * (1 - lambda_value) + original_q * lambda_value


def re_ranking(q_g_dist=None, q_q_dist=None, g_g_dist=None, k1=20, k2=6, lambda_value=0.3,
               min_sum_fn=minplus, staged=None, inputs_box=None, valid=None):
    """Re-ranked (q, g) distance matrix from the three distance matrices,
    computed on their device. ``min_sum_fn`` is the Jaccard min-sum: the
    min-plus kernel wrapper, or ``ops.minplus_plain`` to check it.

    ``staged`` forces the staged builder on or off; None takes it above
    n = 16384 items, as grl_tpu does. ``inputs_box``: a list ``[q_g, q_q,
    g_g]`` passed instead of the three matrices and emptied on entry, so
    that they free once the builder has read them (a caller passing them
    positionally keeps them alive for the whole call). ``valid``: ``(nq,
    ng)`` valid counts of capacity-padded inputs (the serve daemon's index
    past the padded builder's scale); forces the staged builder, whose
    first stage then masks the padding. Output rows past nq and columns
    past ng are garbage; callers slice. Requires ``nq + ng >= k1 + 1``."""
    if inputs_box is not None:
        q_g_dist, q_q_dist, g_g_dist = inputs_box
        inputs_box.clear()
    query_num = q_g_dist.shape[0]
    gallery_num = g_g_dist.shape[0]
    n_total = query_num + gallery_num
    if valid is not None:
        staged = True  # the masked first stage exists only in the staged builder
    if staged is None:
        staged = n_total > 16384
    if staged:
        box = [q_g_dist, q_q_dist, g_g_dist]
        q_g_dist = q_q_dist = g_g_dist = None
        # above one slab, query expansion (s5) is deferred into the min-plus
        # slab loop, so the expanded V never exists beside V
        defer = n_total > _MINPLUS_CHUNK
        v, original_q, qexpand_idx = _build_v_staged(box, k1, k2, defer_qexpand=defer, valid=valid)
        if defer:
            min_sum = _min_sum_slabs(v, qexpand_idx, query_num, min_sum_fn)
        else:
            min_sum = min_sum_fn(v[:query_num], v)
    else:
        original = torch.cat(
            [torch.cat([q_q_dist, q_g_dist], dim=1), torch.cat([q_g_dist.T, g_g_dist], dim=1)],
            dim=0,
        )
        q_g_dist = q_q_dist = g_g_dist = None
        original = original.square().to(torch.float32)
        original = (original / original.max(dim=0).values).T.contiguous()
        v = v_from_original(original, k1, k2)
        min_sum = min_sum_fn(v[:query_num], v)
        original_q = original[:query_num]
        del original
    del v
    final = _jaccard_blend(min_sum, original_q, lambda_value)
    return final[:, query_num : query_num + gallery_num]


def _min_sum_slabs(v, qexpand_idx, query_num, min_sum_fn):
    """``min_sum_fn(vq, V')`` one slab of ``_MINPLUS_CHUNK`` rows of V' at a
    time, where V' is V after query expansion (``qexpand_idx``; None means
    no expansion, k2 = 1): each slab of expanded rows is built and consumed
    at once, so the expanded V never exists whole."""
    n = v.shape[0]
    vq = None if qexpand_idx is not None else v[:query_num]
    blocks = []
    for s0 in range(0, n, _MINPLUS_CHUNK):
        if qexpand_idx is None:
            slab = v[s0 : s0 + _MINPLUS_CHUNK]
        else:
            slab = _qexpand_rows(v, qexpand_idx[s0 : s0 + _MINPLUS_CHUNK])
            if s0 == 0:
                # the query rows are a prefix of slab 0: copy them out, so the
                # slab still frees, instead of gathering them again
                vq = (padded_empty(query_num, n, v.device).copy_(slab[:query_num])
                      if query_num <= slab.shape[0] else _qexpand_rows(v, qexpand_idx[:query_num]))
        blocks.append(min_sum_fn(vq, slab))
        del slab
    return torch.cat(blocks, dim=1)


def _qexpand_rows(v, idx2_rows, out=None):
    """Query expansion (s5) of a row subset: the mean of v's rows gathered by
    each entry of ``idx2_rows`` (r, kk), summed in grl_tpu's order, into
    ``out`` (default: new 16-byte aligned rows)."""
    kk = idx2_rows.shape[1]
    if out is None:
        out = padded_empty(idx2_rows.shape[0], v.shape[1], v.device)
    if kk == 1:
        return out.copy_(v[idx2_rows[:, 0]])
    acc = v[idx2_rows[:, 0]]
    for j in range(1, kk):
        acc += v[idx2_rows[:, j]]
    return torch.div(acc, kk, out=out)


def _build_v_staged(box, k1=20, k2=6, defer_qexpand=False, valid=None):
    """Memory-lean membership-weight builder (grl_tpu's ``_build_v_staged``
    and its stage bodies): the same math as ``v_from_original`` in stages,
    so that no stage holds more than one n² fp32 matrix beside 1-byte
    adjacencies and row-block temporaries.

    - s1 assembles the NEGATED normalized distance matrix block by block
      straight from the three inputs (no n² concatenation), in 16-byte
      aligned rows; with ``valid`` it masks the capacity padding as
      ``re_ranking_padded`` does (pads at −2.0, zero diagonal);
    - s2 keeps the top-k indices only, sorted a row block at a time in
      ``top_k``'s order (``lax.top_k``'s);
    - s3a builds the bool reciprocal adjacencies row block by row block;
    - s3b counts the expansion from bf16 slabs (integers ≤ k1+1, exact);
    - s4 forms ``exp(neg)·expansion``, row-normalized, in place over neg;
    - s5 averages each row over its k2 nearest, row block by row block.

    ``box`` is a list ``[q_g, q_q, g_g]``, emptied on entry so the inputs
    free after s1. Returns ``(v, original[:q], idx_2)``: with
    ``defer_qexpand`` s5 is skipped and ``idx_2`` (None when k2 == 1) is
    left for ``_qexpand_rows``; otherwise ``idx_2`` is None."""
    q_g, q_q, g_g = box
    box.clear()
    q = q_g.shape[0]
    n = q + g_g.shape[0]
    neg = _s1_negated(q_g, q_q, g_g, valid)
    del q_g, q_q, g_g
    half = int(np.around(k1 / 2.0)) + 1
    # numpy's rank[:, :k] clamps when k > n; slicing the (n, min(k, n)) top does too
    top = _s2_topk(neg, max(k1 + 1, half, k2))
    idx_k1, idx_half = top[:, : k1 + 1], top[:, :half]
    idx_2 = top[:, :k2] if k2 != 1 else None
    original_q = -neg[:q]
    expansion = _s3b_expansion(_s3a_reciprocal(idx_k1, n), _s3a_reciprocal(idx_half, n))
    # s4, in place: neg becomes V (exp(-original) == exp(neg))
    v = neg.exp_()
    v.mul_(expansion)
    del expansion
    v.div_(v.sum(dim=1, keepdim=True))
    if defer_qexpand or idx_2 is None:
        return v, original_q, idx_2 if defer_qexpand else None
    out = padded_empty(n, n, v.device)
    for s in range(0, n, _STAGE_BLOCK):
        _qexpand_rows(v, idx_2[s : s + _STAGE_BLOCK], out=out[s : s + _STAGE_BLOCK])
    return out, original_q, None


def _s1_negated(q_g, q_q, g_g, valid):
    """s1: ``-(sq(c) / colmax(sq(c))).T`` for ``c = [[q_q, q_g], [q_gᵀ,
    g_g]]``, assembled by output rows: row j of the result is column j of
    ``sq(c)`` over its maximum, so each row block is read from column
    slices of the inputs. With ``valid = (nq, ng)`` the invalid entries
    enter no maximum (floored at 1e-30), land at −2.0 (below the
    normalized minimum −1.0), and the diagonal is 0, so pad items'
    reciprocal sets are pad-only and never reach a valid row's V."""
    q, g = q_q.shape[0], g_g.shape[0]
    device = q_q.device
    sq_qq = q_q.square().to(torch.float32)
    sq_qg = q_g.square().to(torch.float32)
    if valid is not None:
        vq = torch.arange(q, device=device) < valid[0]
        vg = torch.arange(g, device=device) < valid[1]
        cols_valid = torch.cat([vq, vg])
        sq_qq = torch.where(vq[:, None] & vq[None, :], sq_qq, 0.0)
        sq_qg = torch.where(vq[:, None] & vg[None, :], sq_qg, 0.0)
    # column maxima of the whole concatenation, from per-input reductions
    gg_colmax = torch.zeros(g, dtype=torch.float32, device=device)
    for s in range(0, g, _STAGE_BLOCK):
        sq = g_g[s : s + _STAGE_BLOCK].square().to(torch.float32)
        if valid is not None:
            sq = torch.where(vg[s : s + _STAGE_BLOCK, None] & vg[None, :], sq, 0.0)
        gg_colmax = torch.maximum(gg_colmax, sq.max(dim=0).values)
    mx = torch.cat([torch.maximum(sq_qq.max(dim=0).values, sq_qg.max(dim=1).values),
                    torch.maximum(sq_qg.max(dim=0).values, gg_colmax)])
    if valid is not None:
        mx = mx.clamp(min=1e-30)
    out = padded_empty(q + g, q + g, device)
    out_q = -torch.cat([sq_qq.T, sq_qg], dim=1) / mx[:q, None]
    if valid is not None:
        out_q = torch.where(vq[:, None] & cols_valid[None, :], out_q, -2.0)
    out[:q] = out_q
    del out_q, sq_qq, sq_qg
    for s in range(0, g, _STAGE_BLOCK):
        e = min(s + _STAGE_BLOCK, g)
        blk = torch.cat([q_g[:, s:e].square().to(torch.float32).T,
                         g_g[:, s:e].square().to(torch.float32).T], dim=1)
        blk = -blk / mx[q + s : q + e, None]
        if valid is not None:
            blk = torch.where(vg[s:e, None] & cols_valid[None, :], blk, -2.0)
        out[q + s : q + e] = blk
    if valid is not None:
        out.diagonal().zero_()
    return out


def _s2_topk(neg, k):
    """s2: the (n, min(k, n)) indices of every row's largest entries of
    ``neg`` (nearest items) in ``top_k``'s order, one row block at a time;
    every smaller k is a prefix. (The masked first stage leaves a +0.0
    diagonal among -0.0 entries, where the total order and the IEEE
    comparison part.)"""
    n = neg.shape[0]
    k = min(k, n)
    top = torch.empty((n, k), dtype=torch.int64, device=neg.device)
    for s in range(0, n, _STAGE_BLOCK):
        top[s : s + _STAGE_BLOCK] = top_k(neg[s : s + _STAGE_BLOCK], k)[1]
    return top


def _s3a_reciprocal(idx, n):
    """s3a: bool ``A ∧ Aᵀ`` of the top-k adjacency ``A`` given by ``idx``,
    row block by row block (each block reads an (r, n) row slice and an
    (n, r) column slice of A)."""
    a = torch.zeros((n, n), dtype=torch.bool, device=idx.device)
    a.scatter_(1, idx, True)
    out = torch.empty_like(a)
    for s in range(0, n, _STAGE_BLOCK):
        out[s : s + _STAGE_BLOCK] = a[s : s + _STAGE_BLOCK] & a[:, s : s + _STAGE_BLOCK].T
    return out


def _s3b_expansion(r, b):
    """s3b: the bool expansion ``R'`` from reciprocal sets ``r`` and half
    sets ``b``, one row block of r at a time, with only (rows, n) slabs cast
    to bf16 for the products (0/1 operands: every count is an integer ≤
    k1+1, exact in bf16 under any order of accumulation)."""
    n = r.shape[0]
    thresh = (2.0 / 3.0) * b.sum(dim=1, dtype=torch.float32)
    out = torch.empty_like(r)
    for s in range(0, n, _STAGE_BLOCK):
        rb = r[s : s + _STAGE_BLOCK]
        rbf = rb.to(torch.bfloat16)
        # overlap[i, c] = |R(i) ∩ B(c)|, by slabs of b's rows (columns c)
        qual = torch.empty_like(rb)
        for m in range(0, n, _STAGE_BLOCK):
            overlap = (rbf @ b[m : m + _STAGE_BLOCK].to(torch.bfloat16).T).to(torch.float32)
            qual[:, m : m + _STAGE_BLOCK] = rb[:, m : m + _STAGE_BLOCK] & (overlap > thresh[None, m : m + _STAGE_BLOCK])
        del rbf
        # expanded = qual @ b, accumulated over slabs of b's rows
        expanded = rb.clone()
        qbf = qual.to(torch.bfloat16)
        for m in range(0, n, _STAGE_BLOCK):
            expanded |= (qbf[:, m : m + _STAGE_BLOCK] @ b[m : m + _STAGE_BLOCK].to(torch.bfloat16)) > 0
        out[s : s + _STAGE_BLOCK] = expanded
    return out


def re_ranking_padded(q_g, q_q, g_g, nq, ng, k1=20, k2=6, lambda_value=0.3, min_sum_fn=minplus):
    """Re-ranking over CAPACITY-PADDED inputs in one program (grl_tpu's
    ``re_ranking_device_padded``): the serve daemon's index grows inside a
    fixed buffer, so the distance matrices carry trailing rows and columns
    of garbage past the valid counts ``nq``/``ng``. Padding enters no
    column maximum, sits at distance 2.0 (above the normalized maximum 1.0)
    with a zero diagonal, so pad items' k-reciprocal sets are pad-only and
    no pad item gives weight to a valid row of V. Output rows past nq and
    columns past ng are garbage; callers slice. Requires ``nq + ng >= k1 +
    1`` (below it the top-k clamps differ from the unpadded math)."""
    Q, G = q_q.shape[0], g_g.shape[0]
    device = q_q.device
    valid = torch.cat([torch.arange(Q, device=device) < nq, torch.arange(G, device=device) < ng])
    pair = valid[:, None] & valid[None, :]
    original = torch.cat([torch.cat([q_q, q_g], dim=1), torch.cat([q_g.T, g_g], dim=1)], dim=0)
    original = torch.where(pair, original.square().to(torch.float32), 0.0)
    colmax = original.max(dim=0).values.clamp(min=1e-30)
    original = torch.where(pair, (original / colmax).T, 2.0).contiguous()
    del pair
    original.fill_diagonal_(0.0)
    v = v_from_original(original, k1, k2)
    min_sum = min_sum_fn(v[:Q], v)
    del v
    final = _jaccard_blend(min_sum, original[:Q], lambda_value)
    return final[:, Q:]


def _topk_adjacency(rank, k):
    n = rank.shape[0]
    adj = np.zeros((n, n), dtype=bool)
    np.put_along_axis(adj, rank[:, :k], True, axis=1)
    return adj


def re_ranking_host(q_g_dist, q_q_dist, g_g_dist, k1=20, k2=6, lambda_value=0.3):
    """grl_tpu's host numpy ``re_ranking`` (reference reid/evaluator/
    rerank.py:37-104), copied: numpy arrays in and out, the Jaccard
    min-sum over V's sparse rows. Its argsort is numpy's default (not
    stable), so its tie order is not the device builders'."""
    query_num = q_g_dist.shape[0]

    original = np.concatenate(
        [
            np.concatenate([q_q_dist, q_g_dist], axis=1),
            np.concatenate([q_g_dist.T, g_g_dist], axis=1),
        ],
        axis=0,
    )
    original = np.power(original, 2).astype(np.float32)
    original = np.transpose(original / np.max(original, axis=0))
    n = original.shape[0]

    rank = np.argsort(original, axis=1).astype(np.int32)

    reciprocal = _topk_adjacency(rank, k1 + 1)
    reciprocal &= reciprocal.T

    half = int(np.around(k1 / 2.0)) + 1
    b = _topk_adjacency(rank, half)
    b &= b.T
    b_sizes = b.sum(axis=1).astype(np.float32)

    # overlap[i, c] = |R(i) ∩ B(c)|; expand R(i) by qualifying candidates'
    # B-sets in one more boolean product.
    rf = reciprocal.astype(np.float32)
    bf = b.astype(np.float32)
    overlap = rf @ bf.T
    qualifies = reciprocal & (overlap > (2.0 / 3.0) * b_sizes[None, :])
    expansion = reciprocal | ((qualifies.astype(np.float32) @ bf) > 0)

    weights = np.exp(-original) * expansion
    v = weights / weights.sum(axis=1, keepdims=True)

    if k2 != 1:
        sel = _topk_adjacency(rank, k2).astype(np.float32)
        v = (sel @ v) / k2

    original = original[:query_num]

    # Sparse min-sum: V rows touch only a few dozen columns.
    inv_index = [np.flatnonzero(v[:, j]) for j in range(n)]
    jaccard = np.zeros((query_num, n), dtype=np.float32)
    for i in range(query_num):
        min_sum = np.zeros(n, dtype=np.float32)
        for j in np.flatnonzero(v[i]):
            rows = inv_index[j]
            min_sum[rows] += np.minimum(v[i, j], v[rows, j])
        jaccard[i] = 1.0 - min_sum / (2.0 - min_sum)

    final = jaccard * (1 - lambda_value) + original * lambda_value
    return final[:, query_num:]
