"""BatchNorm with the statistics of the global batch over a process group.

grl_tpu's data parallelism runs one jitted step over a batch sharded on a
mesh, so the mean in its BatchNorm is the mean over the global batch: XLA
inserts the collective (``grl_tpu/nn/norm.py``). The port runs one process
per card, so it says so: under a group, every BatchNorm of the CNN is a
:class:`GlobalBatchNorm`, whose train-mode statistics are reduced over
every rank of the default process group with grl_tpu's two-pass fp32
arithmetic (all-reduce the sum and the count for the mean, then all-reduce
``Σ(x − mean)²`` for the biased variance). Its backward all-reduces the
two per-channel sums of BatchNorm's gradient, so the input's and the
parameters' gradients are those of a BatchNorm over the joined batch. The
running statistics move with the global mean and the global unbiased
variance (``n/(n−1)`` with the global ``n``), momentum and eps as the
module has them (0.1, 1e-5). Statistics stay fp32 (or the input's width,
if wider) under a bf16 input, and the output takes the input's dtype, as
grl_tpu's. In eval mode it is ``torch.nn.BatchNorm`` unchanged.

On CUDA tensors the same statistics come from torch's fused BatchNorm
ops, as ``torch.nn.SyncBatchNorm`` builds them: each rank's mean and
inverse std in one pass (Welford, fp32), one all-gather of those and the
counts, combined into the global mean and variance (which also moves the
running statistics), one normalization pass; backward one reduction pass,
one all-reduce of its two sums, one elementwise pass. The two-pass code
above, a handful of unfused passes and three collectives a layer, stays
for CPU tensors (gloo), where the fused ops do not exist.
``torch.nn.SyncBatchNorm`` itself is not used: it refuses CPU tensors, so
it would leave the gloo path without global statistics.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from .distributed import reduced


class _GlobalBatchNormFn(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch. Forward: grl_tpu's
    two-pass statistics, each pass one all-reduce, then the normalization
    in place on the centred input. Backward: BatchNorm's gradient, whose
    two per-channel sums (of ``dy`` and ``dy·x̂``) are all-reduced, so each
    rank's input gets the gradient of the joined batch's BatchNorm; the
    weight and bias get this rank's share, which the group step sums with
    every other gradient. It saves only the input and per-channel values,
    where autograd over the same ops would hold each intermediate."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        wide = torch.promote_types(x.dtype, torch.float32)
        x32 = x.to(wide)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        sums = reduced(torch.cat([x32.sum(dims), x32.new_tensor([float(x.numel() // x.shape[1])])]))
        n = sums[-1]
        mean = sums[:-1] / n
        centred = x32 - mean.view(shape)
        var = reduced(centred.square().sum(dims)) / n
        invstd = torch.rsqrt(var + eps)
        # (x - mean)·(w/σ) + b, as torch's train-mode BatchNorm: the folded
        # x·(w/σ) + (b - mean·w/σ) loses digits where |mean| ≫ σ
        y = centred.mul_((invstd if weight is None else invstd * weight.to(wide)).view(shape))
        if bias is not None:
            y = y.add_(bias.to(wide).view(shape))
        ctx.save_for_backward(x, mean, invstd, weight)
        ctx.n = n
        ctx.mark_non_differentiable(mean, var, n)
        return y.to(x.dtype), mean, var, n

    @staticmethod
    def backward(ctx, dy, _mean, _var, _n):
        x, mean, invstd, weight = ctx.saved_tensors
        wide = mean.dtype
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        dy32 = dy.to(wide)
        xhat = (x.to(wide) - mean.view(shape)).mul_(invstd.view(shape))
        local = torch.cat([dy32.sum(dims), (dy32 * xhat).sum(dims)])
        sum_dy, sum_dy_xhat = reduced(local.clone()).div_(ctx.n).chunk(2)
        scale = invstd if weight is None else invstd * weight.to(wide)
        dx = (dy32 - sum_dy.view(shape)).sub_(xhat.mul_(sum_dy_xhat.view(shape))).mul_(scale.view(shape))
        grad_w, grad_b = local.chunk(2)[::-1]
        return (dx.to(x.dtype), None if weight is None else grad_w.to(weight.dtype),
                None if weight is None else grad_b.to(weight.dtype), None)


def _memory_format(x):
    """``x``'s layout, kept through the fused ops (a channels-last input
    is not copied to NCHW)."""
    if x.dim() == 4 and not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    return torch.contiguous_format


class _FusedGlobalBatchNormFn(torch.autograd.Function):
    """The CUDA form of :class:`_GlobalBatchNormFn` on torch's fused
    BatchNorm ops (the module docstring). The running statistics, where
    given, are moved in place with the global mean and unbiased variance."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum):
        x = x.contiguous(memory_format=_memory_format(x))
        mean, invstd = torch.batch_norm_stats(x, eps)
        count = mean.new_full((1,), x.numel() // x.shape[1])
        local = torch.cat([mean, invstd, count])
        every = local.new_empty(dist.get_world_size() * local.numel())
        dist.all_gather_into_tensor(every, local)
        c = mean.numel()
        every = every.view(-1, 2 * c + 1)
        counts = every[:, -1]
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, every[:, :c].contiguous(), every[:, c:2 * c].contiguous(), running_mean, running_var, momentum, eps,
            counts)
        ctx.save_for_backward(x, weight, mean, invstd, counts.to(torch.int32))
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        dy = dy.contiguous(memory_format=_memory_format(x))
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight, need_x,
                                                                              need_w, need_b)
        dx = None
        if need_x:
            sum_dy, sum_dy_xmu = reduced(torch.cat([sum_dy, sum_dy_xmu])).chunk(2)
            dx = torch.batch_norm_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu, counts)
        return dx, grad_w if need_w else None, grad_b if need_b else None, None, None, None, None


class GlobalBatchNorm(nn.modules.batchnorm._BatchNorm):
    """A BatchNorm over channel dim 1 of (N, C, ...) inputs whose train-mode
    statistics are the global batch's; keys and buffers are BatchNorm's."""

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2-D input (got {x.dim()}-D)")

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        if x.is_cuda:
            track = self.track_running_stats
            y = _FusedGlobalBatchNormFn.apply(x, self.weight, self.bias, self.running_mean if track else None,
                                              self.running_var if track else None, self.eps, self.momentum)
            if track:
                self.num_batches_tracked.add_(1)
            return y
        y, mean, var, n = _GlobalBatchNormFn.apply(x, self.weight, self.bias, self.eps)
        if self.track_running_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.to(self.running_mean.dtype))
                unbiased = var * (n / (n - 1).clamp(min=1))
                self.running_var.mul_(1 - m).add_(m * unbiased.to(self.running_var.dtype))
                self.num_batches_tracked.add_(1)
        return y


def convert_global_batchnorm(module):
    """Swap every ``_BatchNorm`` below ``module`` for a :class:`GlobalBatchNorm`
    in place, sharing its parameters and buffers (so an optimizer built over
    them keeps working, and the state_dict keys stay). Idempotent; returns
    ``module``."""
    for name, child in module.named_children():
        if isinstance(child, GlobalBatchNorm):
            continue
        if isinstance(child, nn.modules.batchnorm._BatchNorm):
            new = GlobalBatchNorm(child.num_features, child.eps, child.momentum, child.affine,
                                  child.track_running_stats)
            if child.affine:
                new.weight, new.bias = child.weight, child.bias
            if child.track_running_stats:
                new.running_mean, new.running_var = child.running_mean, child.running_var
                new.num_batches_tracked = child.num_batches_tracked
            new.train(child.training)
            setattr(module, name, new)
        else:
            convert_global_batchnorm(child)
    return module


__all__ = ["GlobalBatchNorm", "convert_global_batchnorm"]
