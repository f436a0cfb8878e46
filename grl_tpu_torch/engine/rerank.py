"""k-reciprocal re-ranking (Zhong et al., CVPR 2017).

Counterpart of ``grl_tpu/engine/rerank.py``. Definitions (n = #query +
#gallery, D = column-normalized squared dist):
- F(i)         = i's k1+1 nearest (incl. self), a list
- R(i)         = { j ∈ F(i) : i ∈ F(j) } : k-reciprocal sets
- B            : same with the round(k1/2)+1 nearest, H(i)
- expansion: R'(i) = R(i) ∪ { B(c) : c ∈ R(i), |B(c) ∩ R(i)| > ⅔|B(c)| },
  built from the lists F and H by gathers and compares
  (``_expansion_rows``): n·(k1+1)·|H|·(k1+1) steps, where the dense form,
  R = A ∧ Aᵀ for the top-k adjacency A, takes two n³ 0/1 products
- V[i]         = exp(-D[i]) masked to R'(i), row-normalized
- query expansion: V ← mean of V over each row's k2 nearest
- Jaccard dist = 1 − Σ_k min(V[i,k], V[j,k]) / (2 − Σ_k min(...))
- final = (1−λ)·Jaccard + λ·D[:q]

Four builders, as in grl_tpu:
- ``re_ranking`` (``re_ranking_device``): the one-program path
  (``v_from_original``) up to ``ONE_PROGRAM_MAX`` = 16384 items, the staged
  builder (``_build_v_staged``) above it or when ``valid`` counts are given;
- ``re_ranking_padded`` (``re_ranking_device_padded``): one program over
  capacity-padded inputs, the serve daemon's route;
- ``re_ranking_host`` (grl_tpu's host ``re_ranking``): numpy, a copy.

Every device builder ends in the Jaccard min-sum, the hand-written min-plus
kernel (``ops.minplus``), over V built in 16-byte aligned rows
(``ops.padded_empty``) so the kernel reads it in place. The one-program and
padded builders pick each row's nearest columns with the hand-written
selection kernel (``ops.nearest_k``), which reads the row once.

Under a profiler (``utils.profiling.span``, each with the card's time of
its work) the padded and one-program builders are spans by stage:
``rerank.original`` (the joined, normalized distances),
``rerank.nearest`` (each row's first max(k1 + 1, k2) columns of the order),
``rerank.expand`` (the k-reciprocal sets and their
expansion, from the neighbour lists), ``rerank.query_expand`` (V and its k2
average), ``rerank.min_sum`` and ``rerank.blend``. Of the staged and
sharded builders only the blend that ``re_ranking`` shares with the
staged route is spanned.

With ``mesh`` (a ``parallel.Mesh``: one process per card) the staged
builder is row-sharded over the group (``_re_ranking_sharded``): each rank
builds, from its own block of the distances' columns, its rows of every
n² stage, sees the other rows only through the gathered top-k indices and
V's rows passed around the ranks, and runs the min-plus kernel on its own
rows of V. grl_tpu's second mesh variant, the one-program builder with
only its min-sum sharded, computes the same function and is not carried
over.

Not carried over: grl_tpu's caches of compiled stage programs
(``_STAGED_CACHE``, ``_BUILD_V_CACHE``, ``_PADDED_RERANK_CACHE``), since
torch has nothing to compile, and the host-read barriers of its staged
builder (``sync``), whose job the caching allocator's stream-ordered frees
already do.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from ..ops import minplus, nearest_k, padded_empty
from ..parallel import row_block
from ..utils.profiling import span

# B-row slab width of the deferred min-plus loop; row-block width of the
# staged stages. Module constants so tests can shrink them and run the
# multi-slab and ragged-block paths at toy sizes.
_MINPLUS_CHUNK = 8192
_STAGE_BLOCK = 4096
# the most items (queries + gallery) the one-program builder takes, grl_tpu's
# cut; read at each use by ``re_ranking`` and the serve daemon's index, so a
# test that shrinks it drives both onto the staged route at toy n
ONE_PROGRAM_MAX = 16384


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
    n, device = original.shape[0], original.device
    with span("rerank.nearest", device=device):
        # every list below is a prefix of each row's first max(k1 + 1, k2)
        # columns in the stable ascending order
        order = nearest_k(original.contiguous(), max(k1 + 1, k2))

    with span("rerank.expand", device=device):
        # numpy's rank[:, :k] clamps when k > n; so does grl_tpu, and so does the slice
        half = int(np.around(k1 / 2.0)) + 1
        expansion = _expansion_rows(order[:, : k1 + 1], order[:, :half])

    with span("rerank.query_expand", device=device):
        weights = torch.exp(-original) * expansion
        if k2 == 1:
            return torch.div(weights, weights.sum(dim=1, keepdim=True), out=padded_empty(n, n, device))
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
        return torch.div(acc, k2, out=padded_empty(n, n, device))


def _expansion_rows(idx_k1, idx_half, start=0, rows=None):
    """The bool expansion ``R'`` of rows ``[start, start + rows)`` (default:
    to the end), (rows, n), from every row's nearest indices: ``idx_k1``
    (n, k1+1) and ``idx_half`` (n, round(k1/2)+1), each row's first columns
    of the stable ascending order (``ops.nearest_k``; clamped to n).

    The definition's dense ``A ∧ Aᵀ`` and its two 0/1 products, worked out
    on the lists: ``R(i)`` is the members ``j`` of ``F(i) = idx_k1[i]``
    with ``i ∈ F(j)``, a mask over ``F(i)`` from the gather ``F[F(i)]``;
    ``B(c)`` the same over ``H(c) = idx_half[c]``; ``|R(i) ∩ B(c)|`` by
    comparing ``H(c)`` with ``R(i)`` (a row's indices are distinct); and
    ``R'(i)``, at most k1+1 + (k1+1)·|H| columns, scattered into zeros by a
    maximum, which no order of duplicate columns changes. The counts are
    the products' integers, so ``R'`` is theirs bit for bit. The
    temporaries take ~(k1+1)²·|H| bytes a row, under the output's n bytes
    a row at the staged builder's scale."""
    n, device = idx_k1.shape[0], idx_k1.device
    rows = n - start if rows is None else rows
    idx_k1, idx_half = idx_k1.long(), idx_half.long()
    item = torch.arange(n, device=device)
    # B(c) as a mask over H(c), for every c
    b_mask = (idx_half[idx_half] == item[:, None, None]).any(dim=2)
    f = idx_k1[start : start + rows]
    r_mask = (idx_k1[f] == item[start : start + rows, None, None]).any(dim=2)
    h, bc = idx_half[f], b_mask[f]  # H(c) and B(c) over it, for each c in F(i)
    members = torch.where(r_mask, f, -1)
    in_r = (h[..., None] == members[:, None, None, :]).any(dim=3)
    overlap = (in_r & bc).sum(dim=2, dtype=torch.float32)
    qualifies = r_mask & (overlap > (2.0 / 3.0) * bc.sum(dim=2, dtype=torch.float32))
    grow = (qualifies[..., None] & bc).to(torch.uint8)
    out = torch.zeros((rows, n), dtype=torch.uint8, device=device)
    out.scatter_reduce_(1, f, r_mask.to(torch.uint8), reduce="amax")
    # one column of the half lists at a time, so that no matrix is wider than
    # the lists: a sharded rank holds none past its rows' share of n
    for b in range(h.shape[2]):
        out.scatter_reduce_(1, h[..., b], grow[..., b], reduce="amax")
    return out.view(torch.bool)


def _jaccard_blend(min_sum, original_q, lambda_value):
    jaccard = 1.0 - min_sum / (2.0 - min_sum)
    return jaccard * (1 - lambda_value) + original_q * lambda_value


def re_ranking(q_g_dist=None, q_q_dist=None, g_g_dist=None, k1=20, k2=6, lambda_value=0.3,
               min_sum_fn=minplus, inputs_box=None, valid=None, mesh=None, query_num=None):
    """Re-ranked (q, g) distance matrix from the three distance matrices,
    computed on their device. ``min_sum_fn`` is the Jaccard min-sum: the
    min-plus kernel wrapper, or ``ops.minplus_plain`` to check it.

    The staged builder runs above ``ONE_PROGRAM_MAX`` items, as grl_tpu's
    does. ``inputs_box``: a list ``[q_g, q_q, g_g]`` passed instead of the
    three matrices and emptied on entry, so that they free once the builder
    has read them (a caller passing them positionally keeps them alive for
    the whole call). ``valid``: ``(nq,
    ng)`` valid counts of capacity-padded inputs (the serve daemon's index
    past the padded builder's scale); forces the staged builder, whose
    first stage then masks the padding. Output rows past nq and columns
    past ng are garbage; callers slice. Requires ``nq + ng >= k1 + 1``.

    ``mesh``: the row-sharded staged builder over the group, on every rank
    at once. Each rank's ``inputs_box`` then holds ONE matrix: its columns
    ``parallel.row_block(n, mesh)`` of the (n, n) input ``c = [[q_q, q_g],
    [q_gᵀ, g_g]]``, transposed (row j is column j of c; c is symmetric, and
    its columns are what the one-process builder reads, so they round
    alike), and ``query_num`` is q (``evaluator.rerank_columns`` builds
    them from features). Every rank returns the whole (q, g) result."""
    if mesh is not None:
        return _re_ranking_sharded(inputs_box, query_num, mesh, k1, k2, lambda_value, min_sum_fn, valid)
    if inputs_box is not None:
        q_g_dist, q_q_dist, g_g_dist = inputs_box
        inputs_box.clear()
    query_num = q_g_dist.shape[0]
    gallery_num = g_g_dist.shape[0]
    n_total = query_num + gallery_num
    # the masked first stage under ``valid`` exists only in the staged builder
    if valid is not None or n_total > ONE_PROGRAM_MAX:
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
        device = q_g_dist.device
        with span("rerank.original", device=device):
            original = torch.cat(
                [torch.cat([q_q_dist, q_g_dist], dim=1), torch.cat([q_g_dist.T, g_g_dist], dim=1)],
                dim=0,
            )
            q_g_dist = q_q_dist = g_g_dist = None
            original = original.square().to(torch.float32)
            original = (original / original.max(dim=0).values).T.contiguous()
        v = v_from_original(original, k1, k2)
        with span("rerank.min_sum", device=device):
            min_sum = min_sum_fn(v[:query_num], v)
        original_q = original[:query_num]
        del original
    del v
    with span("rerank.blend", device=min_sum.device):
        final = _jaccard_blend(min_sum, original_q, lambda_value)
    return final[:, query_num : query_num + gallery_num]


def _re_ranking_sharded(box, q, mesh, k1, k2, lambda_value, min_sum_fn, valid):
    """The staged builder row-sharded over ``mesh``; ``box`` holds this
    rank's block of c's columns, transposed (``re_ranking``), and is
    emptied on entry so that the block frees after s1.

    n is padded to ``per · size`` with grl_tpu's phantom items (normalized
    distance 1.0 from every item, 0.0 from themselves; −2.0 and 0.0 under
    ``valid``, like capacity padding), which give no weight to a real row
    and are sliced off. Rank r owns rows ``[r·per, (r+1)·per)`` of every
    stage: of each n² stage buffer it holds ``per × n``, never the whole,
    and its row blocks are ``_STAGE_BLOCK / size`` rows, so that the
    stages' block temporaries (s2's sort of whole rows above all) shrink
    with its share too.

    - s1: its rows of the negated normalized matrix, each row over its own
      maximum (the column maximum of c);
    - s2: its rows' top-k indices, all-gathered (n × k int32: the only view
      of other rows that the set algebra needs);
    - s3: its rows of the expansion, from the gathered indices
      (``_expansion_rows``);
    - s4: its rows of V, in place;
    - s5: its rows of the expanded V, from V's row slabs broadcast by
      their owners in turn (no rank holds V whole);
    - the min-sum: the q expanded query rows broadcast by their owners,
      then the min-plus kernel on its own rows, one ``_MINPLUS_CHUNK`` slab
      at a time: columns ``[r·per, (r+1)·per)`` of the (q, n) min-sum;
    - the blend with ``original[:q]``'s same columns, which are its rows'
      first q entries over the query rows' maxima (gathered); then the
      ranks' column blocks are all-gathered."""
    (cols,) = box
    box.clear()
    r, n0 = cols.shape
    start, stop, per = row_block(n0, mesh)
    if r != stop - start:
        raise ValueError(f"rank {mesh.rank} holds {r} columns of c; row_block gives [{start}, {stop})")
    block = -(-_STAGE_BLOCK // mesh.size)
    neg, mx, sq_q, col_valid = _s1_rows(cols, q, start, per, per * mesh.size, valid, block)
    del cols
    half = int(np.around(k1 / 2.0)) + 1
    top = _gather_rows(_s2_topk(neg, max(k1 + 1, half, k2), block).to(torch.int32), mesh)  # (n, k)
    mx_q = _gather_rows(mx, mesh)[:q]
    expansion = _expansion_rows(top[:, : k1 + 1], top[:, :half], start, per)
    # s4, in place: neg becomes V
    v = neg.exp_()
    v.mul_(expansion)
    del expansion
    v.div_(v.sum(dim=1, keepdim=True))
    if k2 != 1:
        v = _qexpand_sharded(v, top[start : start + per, :k2].long(), mesh, block)
    del top
    vq = _broadcast_query_rows(v, q, mesh)
    min_sum = torch.cat([min_sum_fn(vq, v[s : s + _MINPLUS_CHUNK]) for s in range(0, per, _MINPLUS_CHUNK)], dim=1)
    del v, vq
    # original[i, j] for the query rows i and this rank's columns j
    original_q = sq_q.T / mx_q[:, None]
    if valid is not None:
        original_q = torch.where(col_valid[:q, None] & col_valid[None, start : start + per], original_q, 2.0)
    final = _jaccard_blend(min_sum, original_q, lambda_value).contiguous()
    del min_sum, original_q
    return torch.cat(_all_gather(final, mesh), dim=1)[:, q:n0]


def _all_gather(t, mesh):
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    return parts


def _gather_rows(t, mesh):
    """Every rank's equal-shaped ``t`` concatenated along rows, in rank order."""
    return torch.cat(_all_gather(t.contiguous(), mesh))


def _s1_rows(cols, q, start, per, n, valid, block):
    """s1 on this rank's ``per`` rows: row j is ``-sq(c[:, j]) /
    max(sq(c[:, j]))`` (the one-process stage's row j) for its columns
    ``cols`` of c, in 16-byte aligned rows of all n items, with the phantom
    items and ``valid``'s mask applied. Returns ``(neg, mx, sq_q,
    col_valid)``: the rows' maxima (1 on phantom rows), their squared
    entries against the q query items, and which of the n items are valid
    (None without ``valid``)."""
    r, n0 = cols.shape
    device = cols.device
    masked = valid is not None
    out = padded_empty(per, n, device).fill_(-2.0 if masked else -1.0)
    mx = torch.ones(per, dtype=torch.float32, device=device)
    sq_q = torch.zeros((per, q), dtype=torch.float32, device=device)
    col_valid = None
    if masked:
        item = torch.arange(n, device=device)
        col_valid = torch.where(item < q, item < valid[0], (item - q < valid[1]) & (item < n0))
    for s in range(0, r, block):
        e = min(s + block, r)
        blk = cols[s:e].square().to(torch.float32)
        if masked:
            pair = col_valid[start + s : start + e, None] & col_valid[None, :n0]
            blk = torch.where(pair, blk, 0.0)
        m = blk.max(dim=1).values
        if masked:
            m = m.clamp(min=1e-30)
        sq_q[s:e] = blk[:, :q]
        blk = blk.neg_().div_(m[:, None])  # -(x / m), in the block's own buffer
        if masked:
            blk = torch.where(pair, blk, -2.0)
        out[s:e, :n0] = blk
        mx[s:e] = m
    # a zero diagonal: every item's under the mask, as the one-process
    # masked stage; otherwise the phantoms' (the real ones are -0.0 already)
    diag = torch.arange(0 if masked else r, per, device=device)
    out[diag, start + diag] = 0.0
    return out, mx, sq_q, col_valid


def _padded_rows(x, a, b):
    """Rows ``[a, b)`` of a ``padded_empty`` matrix as one contiguous block of
    whole padded rows: what a collective sends or receives."""
    stride = x.stride(0)
    return x.as_strided((b - a, stride), (stride, 1), x.storage_offset() + a * stride)


def _qexpand_sharded(v, idx2, mesh, block):
    """s5 for this rank's rows: each row the mean of V's rows ``idx2`` (per,
    kk; global indices). Every rank in turn broadcasts its rows of V, a
    ``block`` rows at a time, and each rank adds the slab's rows
    that its own rows name (one add per row and index column: the rows of
    one ``index_add_`` are distinct)."""
    per, n = v.shape
    kk = idx2.shape[1]
    out = padded_empty(per, n, v.device).zero_()
    recv = torch.empty((min(block, per), v.stride(0)), dtype=v.dtype, device=v.device)
    for src in range(mesh.size):
        for s in range(0, per, block):
            e = min(s + block, per)
            slab = _padded_rows(v, s, e) if src == mesh.rank else recv[: e - s]
            dist.broadcast(slab, src=src)
            slab = slab[:, :n]
            for j in range(kk):
                t = idx2[:, j] - (src * per + s)
                sel = ((t >= 0) & (t < e - s)).nonzero()[:, 0]
                for c in range(0, sel.numel(), block):
                    i = sel[c : c + block]
                    out.index_add_(0, i, slab.index_select(0, t[i]))
    return out.div_(kk)


def _broadcast_query_rows(v, q, mesh):
    """The q query rows of V on every rank, each owner broadcasting its
    share, in 16-byte aligned rows that the kernel reads in place."""
    per, n = v.shape
    vq = padded_empty(q, n, v.device)
    for src in range(mesh.size):
        a, b = src * per, min((src + 1) * per, q)
        if a >= q:
            break
        if src == mesh.rank:
            vq[a:b] = v[: b - a]
        dist.broadcast(_padded_rows(vq, a, b), src=src)
    return vq


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
    - s3 builds the bool expansion from the indices (``_expansion_rows``);
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
    expansion = _expansion_rows(idx_k1, idx_half)
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


def _s2_topk(neg, k, block=None):
    """s2: the (rows, min(k, n)) indices of every row's largest entries of
    ``neg`` (nearest items) in ``top_k``'s order, one row block at a time;
    every smaller k is a prefix. (The masked first stage leaves a +0.0
    diagonal among -0.0 entries, where the total order and the IEEE
    comparison part.) ``block``: rows per sort (default ``_STAGE_BLOCK``)."""
    rows, n = neg.shape
    k = min(k, n)
    block = block or _STAGE_BLOCK
    top = torch.empty((rows, k), dtype=torch.int64, device=neg.device)
    for s in range(0, rows, block):
        top[s : s + block] = top_k(neg[s : s + block], k)[1]
    return top


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
    with span("rerank.original", device=device):
        valid = torch.cat([torch.arange(Q, device=device) < nq, torch.arange(G, device=device) < ng])
        pair = valid[:, None] & valid[None, :]
        original = torch.cat([torch.cat([q_q, q_g], dim=1), torch.cat([q_g.T, g_g], dim=1)], dim=0)
        original = torch.where(pair, original.square().to(torch.float32), 0.0)
        colmax = original.max(dim=0).values.clamp(min=1e-30)
        original = torch.where(pair, (original / colmax).T, 2.0).contiguous()
        del pair
        original.fill_diagonal_(0.0)
    v = v_from_original(original, k1, k2)
    with span("rerank.min_sum", device=device):
        min_sum = min_sum_fn(v[:Q], v)
    del v
    with span("rerank.blend", device=device):
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
