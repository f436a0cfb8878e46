"""The GRL model in plain PyTorch: ResNet-50 (last stride 1), GCE, the
bidirectional TRL, the BN-neck and Siamese attention pooling, written as
functions over one dict of tensors keyed by the system's state-dict names
(``cnn.backbone.base.layer1.0.conv1.weight`` ...).

It follows the published model (Liu et al., CVPR 2021, github.com/
flysnowtiger/GRL) in its plain form: GCE's first mask conv runs over the
concatenated frame map and broadcast global feature, the TRL's enhanced
frame map is formed before it is pooled, and the clip's two attention
halves are pooled separately in training. Everything computes in fp32;
``precision`` rounds the operands of every product (convolutions and
matrix products) first, forward and backward:

- ``"fp32"``: no rounding (the caller turns TF32 off);
- ``"tf32"``: operands rounded to TF32's 10-bit mantissa, to nearest;
- ``"fp8"``: operands rounded to float8 e4m3 under one scale per tensor
  (its largest magnitude maps to 448).

BatchNorm runs in one of three modes: ``"eval"`` (running statistics),
``"train"`` (batch statistics) and ``"calibrate"`` (batch statistics,
which are also written back as the running statistics, averaged over the
calls a layer gets: the benchmark's weights are calibrated so).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PRECISIONS = ("fp32", "tf32", "fp8")


def round_operand(x, precision):
    """``x`` as the operand of a product at ``precision``."""
    if precision == "tf32":
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    if precision == "fp8":
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x


class _Conv(torch.autograd.Function):
    """conv2d with every product's operands rounded, the gradients too."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, precision):
        ctx.save_for_backward(x, w)
        ctx.conf = stride, padding, precision
        r = lambda t: round_operand(t, precision)
        return F.conv2d(r(x), r(w), stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, precision = ctx.conf
        r = lambda t: round_operand(t, precision)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = conv2d_input(x.shape, r(w), r(g), stride=stride, padding=padding)
        if ctx.needs_input_grad[1]:
            gw = conv2d_weight(r(x), w.shape, r(g), stride=stride, padding=padding)
        return gx, gw, None, None, None


class _MatMul(torch.autograd.Function):
    """``a @ b`` (batched or not) with rounded operands, the gradients too."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ctx.save_for_backward(a, b)
        ctx.precision = precision
        return round_operand(a, precision) @ round_operand(b, precision)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        r = lambda t: round_operand(t, ctx.precision)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = r(g) @ r(b).transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            gb = r(a).transpose(-1, -2) @ r(g)
        return ga, gb, None


class Net:
    """The weights ``w`` (name -> tensor), a BatchNorm ``mode`` and the
    products' ``precision``. In ``"calibrate"`` mode ``finish_calibration``
    writes the averaged batch statistics into ``w``."""

    def __init__(self, w, mode="eval", precision="fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
        self.w = w
        self.mode = mode
        self.precision = precision
        self._stats = {}

    # -- primitives ---------------------------------------------------------
    def matmul(self, a, b):
        if self.precision == "fp32":
            return a @ b
        return _MatMul.apply(a, b, self.precision)

    def conv(self, name, x, stride=1, padding=0):
        w = self.w[name + ".weight"]
        if self.precision == "fp32":
            y = F.conv2d(x, w, stride=stride, padding=padding)
        else:
            y = _Conv.apply(x, w, stride, padding, self.precision)
        bias = self.w.get(name + ".bias")
        return y if bias is None else y + bias[:, None, None]

    def linear(self, name, x):
        y = self.matmul(x, self.w[name + ".weight"].T)
        bias = self.w.get(name + ".bias")
        return y if bias is None else y + bias

    def bn(self, name, x):
        """BatchNorm over every dim but dim 1."""
        dims = [d for d in range(x.dim()) if d != 1]
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        if self.mode == "eval":
            mean, var = self.w[name + ".running_mean"], self.w[name + ".running_var"]
        else:
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            if self.mode == "calibrate":
                acc = self._stats.setdefault(name, [0.0, 0.0, 0])
                acc[0] = acc[0] + mean.detach()
                acc[1] = acc[1] + var.detach()
                acc[2] += 1
        scale = self.w[name + ".weight"] / torch.sqrt(var + BN_EPS)
        return (x - mean.view(shape)) * scale.view(shape) + self.w[name + ".bias"].view(shape)

    def finish_calibration(self, var_floor=0.1):
        """Write the averaged statistics; each layer's variances no lower
        than ``var_floor`` times their median, so that no channel's scale
        is set by a variance that a few clips happened to leave near 0."""
        for name, (mean, var, n) in self._stats.items():
            var = var / n
            self.w[name + ".running_mean"].copy_(mean / n)
            self.w[name + ".running_var"].copy_(var.clamp(min=var_floor * float(var.median())))
        self._stats = {}

    # -- the trunk ----------------------------------------------------------
    def bottleneck(self, name, x, stride, downsample):
        out = F.relu(self.bn(name + ".bn1", self.conv(name + ".conv1", x)))
        out = F.relu(self.bn(name + ".bn2", self.conv(name + ".conv2", out, stride=stride, padding=1)))
        out = self.bn(name + ".bn3", self.conv(name + ".conv3", out))
        if downsample:
            x = self.bn(name + ".downsample.1", self.conv(name + ".downsample.0", x, stride=stride))
        return F.relu(out + x)

    def trunk(self, x, layers, last_stride=1):
        p = "cnn.backbone.base"
        x = F.relu(self.bn(p + ".bn1", self.conv(p + ".conv1", x, stride=2, padding=3)))
        x = F.max_pool2d(x, 3, 2, 1)
        for li, (blocks, stride) in enumerate(zip(layers, (1, 2, 2, last_stride)), start=1):
            for bi in range(blocks):
                x = self.bottleneck(f"{p}.layer{li}.{bi}", x, stride if bi == 0 else 1, bi == 0)
        return x

    # -- GCE, TRL, the neck ----------------------------------------------------
    def gce(self, x, b, t):
        """Trunk output (b·t, C, h, w) -> (x_uncorr, x_corr), each (b, t, C, h, w)."""
        p = "cnn.backbone"
        _, c, h, w = x.shape
        clip = x.view(b, t, c, h, w)
        glo = F.relu(self.bn(p + ".glo_fc.1", self.linear(p + ".glo_fc.0", clip.mean(dim=(1, 3, 4)))))
        glo_map = glo[:, None, :, None, None].expand(b, t, glo.shape[1], h, w).reshape(b * t, -1, h, w)
        y = self.bn(p + ".corr_atte.1", self.conv(p + ".corr_atte.0", torch.cat([x, glo_map], dim=1)))
        y = F.relu(self.bn(p + ".corr_atte.3", self.conv(p + ".corr_atte.2", y)))
        mask = torch.sigmoid(self.bn(p + ".corr_atte.6", self.conv(p + ".corr_atte.5", y)))
        return (x * (1.0 - mask)).view(b, t, c, h, w), (x * mask).view(b, t, c, h, w)

    def memory_block(self, name, x):
        out = F.relu(self.bn(name + ".bn1", self.conv(name + ".conv1", x)))
        out = F.relu(self.bn(name + ".bn2", self.conv(name + ".conv2", out)))
        return F.relu(self.bn(name + ".bn3", self.conv(name + ".conv3", out)) + x)

    def trl_direction(self, name, x_corr, x_uncorr, reverse):
        t = x_corr.shape[1]
        memo = x_uncorr.mean(dim=1)
        feats = [None] * t
        for i in (range(t - 1, -1, -1) if reverse else range(t)):
            frame = x_corr[:, i]
            f1 = F.relu(self.conv(name + ".f1", memo))
            f2 = F.relu(self.conv(name + ".f2", frame))
            diff = (f1 - f2).square().mean(dim=(2, 3))
            atte = torch.sigmoid(self.linear(name + ".atte.2", F.relu(self.linear(name + ".atte.0", diff))))
            enhanced = frame * atte[:, :, None, None] + frame
            feats[i] = enhanced.mean(dim=(2, 3))
            memo = self.memory_block(name + ".memo", memo + x_uncorr[:, i])
        return torch.stack(feats, dim=1), memo

    def grl(self, clips, layers):
        """Normalized float clips (b, t, h, w, 3) -> (f_uncorr (b, C), f_corr (b, t, C))."""
        b, t, h, w, c = clips.shape
        x = self.trunk(clips.permute(0, 1, 4, 2, 3).reshape(b * t, c, h, w), layers)
        x_uncorr, x_corr = self.gce(x, b, t)
        p = "cnn.temporal_learning_block"
        f_fwd, memo_f = self.trl_direction(p + ".fwd", x_corr, x_uncorr, reverse=False)
        f_bwd, memo_b = self.trl_direction(p + ".bwd", x_corr, x_uncorr, reverse=True)
        f_uncorr = memo_f.mean(dim=(2, 3)) + memo_b.mean(dim=(2, 3))
        f_corr = f_fwd + f_bwd
        ch = f_corr.shape[2]
        f_corr = F.normalize(self.bn("cnn.corr_bn", f_corr.reshape(b * t, ch)), dim=1).view(b, t, ch)
        f_uncorr = F.normalize(self.bn("cnn.uncorr_bn", f_uncorr), dim=1)
        return f_uncorr, f_corr

    # -- Siamese -----------------------------------------------------------------
    def attention_pool(self, name, x):
        """(b, t, C) -> (b, C): softmax(Q Kᵀ) over the raw frames, summed over t."""
        b, t, c = x.shape
        flat = x.reshape(b * t, c)

        def unit(y):
            return y / y.square().sum(dim=1, keepdim=True).sqrt()

        q = unit(self.bn(name + ".featQ_bn", self.linear(name + ".featQ", flat))).view(b, t, -1)
        k = unit(self.bn(name + ".featK_bn", self.linear(name + ".featK", flat))).view(b, t, -1)
        weights = torch.softmax(self.matmul(q, k.transpose(1, 2)), dim=-1)
        return unit(self.matmul(weights, x).sum(dim=1))

    def verification(self, name, probe, gallery):
        """All probe x gallery squared differences -> BN -> 2-way scores (Np, Ng, 2)."""
        diff = (probe[:, None, :] - gallery[None, :, :]).square().reshape(-1, probe.shape[1])
        scores = self.linear(name + ".classifierlinear", self.bn(name + ".classifierBN", diff))
        return scores.view(probe.shape[0], gallery.shape[0], -1)


def normalize(clips_u8):
    """uint8 clips (..., 3) -> ImageNet-normalized fp32."""
    x = clips_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    return (x - mean) / std


def descriptor(net, clips_u8, layers):
    """uint8 clips (b, t, h, w, 3) -> the 6144-d descriptor (b, 3C): the
    uncorrelated feature, the attention-pooled correlated frames and their
    temporal mean."""
    f_uncorr, f_corr = net.grl(normalize(clips_u8), layers)
    pooled = net.attention_pool("siamese", f_corr)
    return torch.cat([f_uncorr, pooled, f_corr.mean(dim=1)], dim=1)


@torch.no_grad()
def calibrate(w, clips_u8, layers):
    """Set every BatchNorm's running statistics in ``w`` to the batch
    statistics of one descriptor pass over ``clips_u8`` (fp32, products
    unrounded), so that eval-mode activations are normalized."""
    net = Net(w, mode="calibrate", precision="fp32")
    descriptor(net, clips_u8, layers)
    net.finish_calibration()
