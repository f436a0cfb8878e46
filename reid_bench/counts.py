"""Operations of GRL's products and of re-ranking's min-sum, counted from
shapes (a multiply-add is two operations).

A product is counted once for each time the model's mathematics needs it,
whatever carries it out: every convolution and matrix product of the
descriptor; for a training step the forward's and, for each operand that
needs a gradient, the backward's (a convolution's input gradient and its
weight gradient are one forward's operations each; the trunk's first
convolution has no input gradient). GCE's first mask convolution is
counted split, as its frame half (a 1x1 convolution at every pixel) and
its global half (a matrix product once per clip), since the global
feature is the same at every pixel of a clip. Elementwise work, norms and
reductions are not counted.

``conv`` is what convolution layers carry (the trunk, GCE's frame half and
its two later mask convolutions, the TRL's projections and memory
blocks); ``total`` adds the matrix products.
"""

from __future__ import annotations


def _out(size, stride):
    return (size - 1) // stride + 1


def trunk_convs(layers, width, h, w, in_ch=3, last_stride=1):
    """``[(cin, cout, k, h_out, w_out)]`` of the ResNet trunk's
    convolutions for one frame, the first one first; also the output's
    ``(channels, h, w)``."""
    convs = []
    h, w = _out(h, 2), _out(w, 2)
    convs.append((in_ch, width, 7, h, w))
    h, w = _out(h, 2), _out(w, 2)  # the max pool
    cin = width
    for li, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, last_stride))):
        planes = width * 2**li
        for bi in range(blocks):
            s = stride if bi == 0 else 1
            ho, wo = _out(h, s), _out(w, s)
            convs += [(cin, planes, 1, h, w), (planes, planes, 3, ho, wo), (planes, planes * 4, 1, ho, wo)]
            if bi == 0:
                convs.append((cin, planes * 4, 1, ho, wo))
            cin, h, w = planes * 4, ho, wo
    return convs, (cin, h, w)


def _conv_ops(cin, cout, k, h, w):
    return 2 * cin * cout * k * k * h * w


def clip_products(cfg):
    """``(conv, matmul)`` forward operations of one clip through the
    model's trunk, GCE and TRL, with ``cfg``'s sizes."""
    t = cfg["seq_len"]
    convs, (c, fh, fw) = trunk_convs(cfg["trunk_layers"], cfg["trunk_width"], cfg["height"], cfg["width"])
    px = fh * fw
    conv = t * sum(_conv_ops(*x) for x in convs)
    glo, mid, se, memo = c // 2, c // 8, c // 16, c // 4
    # GCE: glo_fc, the mask's global half, then its frame half and two more convs per frame
    matmul = 2 * c * glo + 2 * glo * glo
    conv += t * px * 2 * (c * glo + glo * mid + mid * 1)
    # TRL, per direction: f2 over every frame, then per step f1, the SE MLP, the memory block
    per_step_conv = px * 2 * (c * c + c * memo + memo * memo + memo * c)
    conv += 2 * (t * px * 2 * c * c + t * per_step_conv)
    matmul += 2 * t * 2 * (c * se + se * c)
    return conv, matmul


def attention_products(cfg):
    """Forward operations of Siamese attention pooling of one clip."""
    t, c, d = cfg["seq_len"], cfg["feat_dim"], cfg["siamese_out"]
    return t * 2 * 2 * c * d + 2 * t * t * d + 2 * t * t * c


def descriptor_ops(cfg):
    """``{"conv", "total"}`` operations of one clip's descriptor."""
    conv, matmul = clip_products(cfg)
    return {"conv": conv, "total": conv + matmul + attention_products(cfg)}


def train_step_ops(cfg, batch, num_classes):
    """``{"conv", "total"}`` operations of one training step over ``batch``
    clips: the forward and the backward."""
    t, c = cfg["seq_len"], cfg["feat_dim"]
    convs, _ = trunk_convs(cfg["trunk_layers"], cfg["trunk_width"], cfg["height"], cfg["width"])
    conv_f, matmul_f = clip_products(cfg)
    first = t * _conv_ops(*convs[0])  # no input gradient
    conv = batch * (3 * conv_f - first)
    matmul = batch * 3 * (matmul_f + attention_products(cfg))
    pairs = batch // 2
    # the verification classifiers (C -> 2) of every probe x gallery pair: Siamese's, and
    # SiameseVideo's, whose scores only update its BatchNorm and take no gradient
    verification = 2 * pairs * pairs * c * 2
    gram = 2 * batch * batch * c  # the triplet's distances
    oim = 2 * c * num_classes * (batch + 2 * batch * t + batch)  # video, frame value and grad, uncorr
    oim_backward = 2 * c * num_classes * (batch + batch * t + batch)  # lut is constant
    matmul += 3 * verification + verification + 3 * gram + oim + oim_backward
    return {"conv": conv, "total": conv + matmul}


def min_sum_work(rows, n):
    """``(operations, bytes)`` of ``S[i, j] = sum_t min(a[i, t], b[j, t])``
    for ``rows`` query rows against an ``n`` x ``n`` V of fp32: a min and
    an add per term, each input and output byte once."""
    return 2 * rows * n * n, 4 * (rows * n + n * n + rows * n)


def rerank_request_least_s(queries, gallery, dim, peak_fp32, peak_bf16, peak_bytes):
    """The least seconds one re-ranked request of ``queries`` against
    ``gallery`` items of ``dim`` needs at the data-sheet peaks: its
    distance products (queries x gallery and queries x queries, fp32; the
    gallery's own distances change only on enrollment), the two 0/1
    products of k-reciprocal expansion over all ``n = queries + gallery``
    items (overlaps and expansion, each n x n x n, exact in bf16) and the
    min-sum (operations or bytes, whichever bounds it)."""
    n = queries + gallery
    distances = 2 * queries * (gallery + queries) * dim
    ops, nbytes = min_sum_work(queries, n)
    return distances / peak_fp32 + 2 * 2 * n**3 / peak_bf16 + max(ops / peak_fp32, nbytes / peak_bytes)
