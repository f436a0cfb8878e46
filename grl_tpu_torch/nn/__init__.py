"""Conv and linear layers with grl_tpu's ``compute_dtype``, and the L2 norms
(counterparts of ``grl_tpu/nn/conv.py``, ``grl_tpu/nn/linear.py`` and
``grl_tpu/nn/functional.py``).

Under a ``compute_dtype`` (bf16) the input and the fp32 weight are cast at
use, the product comes out in that dtype, and the bias is added after it,
cast to the output's dtype: the product rounds, then the sum, as grl_tpu's
do (a bias fused into ``F.conv2d``/``F.linear`` would round once). With no
``compute_dtype`` the layers are ``torch.nn.Conv2d``/``torch.nn.Linear``
unchanged. Parameters stay fp32 either way, so state dicts, the weight
bridge and checkpoints do not depend on the compute dtype.

The norms compute in fp32 (or wider) and cast back to the input's dtype;
``F.normalize`` on a bf16 tensor would compute in bf16. ``sigmoid`` rounds
where grl_tpu's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _wide(dtype):
    """fp32, or the input's dtype where it is wider (fp64)."""
    return torch.promote_types(dtype, torch.float32)


def conv2d(x, weight, compute_dtype=None, **kwargs):
    """``F.conv2d`` with no bias, operands cast to ``compute_dtype`` first."""
    if compute_dtype is not None:
        x, weight = x.to(compute_dtype), weight.to(compute_dtype)
    return F.conv2d(x, weight, **kwargs)


class Conv2d(nn.Conv2d):
    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        y = conv2d(x, self.weight, self.compute_dtype, stride=self.stride, padding=self.padding,
                   dilation=self.dilation, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class Linear(nn.Linear):
    def __init__(self, *args, compute_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        if self.compute_dtype is None:
            return super().forward(x)
        y = F.linear(x.to(self.compute_dtype), self.weight.to(self.compute_dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


class _Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` in bf16: the value ``1 / (1 + exp(-x))`` op by op,
    each op rounding as XLA's do, and the gradient ``g·(y·(1 − y))`` from
    the output, finite where ``exp(-x)`` overflows."""

    @staticmethod
    def forward(ctx, x):
        y = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * (1.0 - y))


def sigmoid(x):
    """grl_tpu's sigmoid. In bf16, ``torch.sigmoid`` rounds once where
    grl_tpu rounds each op (a bf16 ulp apart in a third of the values); in
    fp32 and wider it is the closer one (an fp32 ulp apart in 0.4 % of the
    values, the formula op by op in 4 %)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _Sigmoid.apply(x)


class Sigmoid(nn.Module):
    def forward(self, x):
        return sigmoid(x)


def l2_normalize(x, dim, eps=1e-12):
    """x / max(‖x‖, eps), as ``F.normalize``, in fp32 or wider."""
    return F.normalize(x.to(_wide(x.dtype)), dim=dim, eps=eps).to(x.dtype)


def l2_unit(x, dim):
    """x / ‖x‖ with no epsilon, in fp32 or wider."""
    w = x.to(_wide(x.dtype))
    return (w / w.square().sum(dim=dim, keepdim=True).sqrt()).to(x.dtype)


__all__ = ["Conv2d", "Linear", "Sigmoid", "conv2d", "l2_normalize", "l2_unit", "sigmoid"]
