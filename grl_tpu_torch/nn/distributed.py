"""Collectives over the default process group for the data-parallel
group: a sum over every rank, and the rows of every rank's tensor in rank
order with a gradient.

Each rank of a group back-propagates its own copy of a loss, so the
backward of the gather sums the incoming gradients over the ranks (an
all-reduce): a rank's rows receive the gradient of the sum of every
rank's loss with respect to them. Over one process group the ranks must
call these in the same order, forward and backward, as for any
collective. ``torch.distributed.nn.functional`` has a gather like it and
warns that it is deprecated; this is the port's own, over
``dist.all_gather`` and ``dist.all_reduce``, on gloo (CPU tensors) and
NCCL (CUDA tensors) alike.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def reduced(t):
    """``t`` (made contiguous, in place where it already is) summed over
    every rank."""
    t = t.contiguous()
    dist.all_reduce(t)
    return t


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        rank, size = dist.get_rank(), dist.get_world_size()
        ctx.rows = (rank * x.shape[0], (rank + 1) * x.shape[0])
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        start, stop = ctx.rows
        return reduced(grad.clone())[start:stop]


def all_gather_rows(x):
    """Every rank's ``x`` concatenated along dim 0 in rank order, on every
    rank (each rank's ``x`` of the same shape); differentiable."""
    return _AllGatherRows.apply(x)


__all__ = ["all_gather_rows", "reduced"]
