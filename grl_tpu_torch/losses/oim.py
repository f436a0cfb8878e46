"""OIM — Online Instance Matching loss with the lookup table as explicit
state (counterpart of ``grl_tpu/losses/oim.py``).

Logits are ``scalar · inputs @ lutᵀ`` with the gradient flowing to the
inputs only: the lut is a buffer, never a parameter. ``update_lut`` applies
the reference's sequential per-row momentum update and renormalization
after the loss, in batch order per id.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def init_lut(num_classes, num_features, device=None, dtype=torch.float32):
    """Zero-initialized lookup table."""
    return torch.zeros((num_classes, num_features), dtype=dtype, device=device)


def oim_logits(inputs, lut, scalar=30.0):
    """Scaled class logits in the lut's dtype (fp32; bf16 features are
    promoted, as grl_tpu's product does); gradient flows to ``inputs`` only."""
    return scalar * (inputs.to(torch.promote_types(inputs.dtype, lut.dtype)) @ lut.detach().T)


def max_repeats(targets):
    """How often the most repeated id occurs in ``targets`` (read on the
    host: a card tensor is copied back, which waits for the card)."""
    ids = torch.as_tensor(targets).cpu()
    return int(torch.unique(ids, return_counts=True)[1].max()) if ids.numel() else 0


@torch.no_grad()
def update_lut(lut, inputs, targets, momentum=0.5, rounds=None):
    """Sequential-semantics momentum update + renorm, as vectorized rounds.

    Row i updates ``lut[targets[i]] <- normalize(m·lut[y] + (1-m)·x_i)``,
    and a repeated id chains through the renormalization in batch order.
    Chains of different ids touch different rows, so round k applies every
    id's (k+1)-th occurrence at once (grl_tpu's ``while_loop`` of rounds);
    the sequential depth is the most repeated id's count. ``rounds`` is that
    count (``max_repeats(targets)``); pass it from host-side ids so the
    update never waits on the card. Returns a new table.
    """
    inputs = inputs.detach().to(lut.dtype)
    n, c = inputs.shape
    targets = targets.to(lut.device)
    if rounds is None:
        rounds = max_repeats(targets)
    # pos[i] = how many earlier batch rows share targets[i]'s id
    same = targets[:, None] == targets[None, :]
    pos = torch.tril(same, diagonal=-1).sum(dim=1)
    # one scratch row absorbs the writes of rows inactive in a round
    scratch = lut.shape[0]
    padded = torch.cat([lut, lut.new_zeros((1, c))])
    for k in range(rounds):
        active = pos == k  # at most one row per id
        new = momentum * padded[targets] + (1.0 - momentum) * inputs
        new = new / new.norm(dim=1, keepdim=True)
        idx = torch.where(active, targets, scratch)
        padded[idx] = torch.where(active[:, None], new, 0.0)
    return padded[:-1]


def cross_entropy(logits, targets):
    """Mean softmax cross-entropy over integer targets."""
    return F.cross_entropy(logits, targets.long())


class OIMLoss:
    """Callable bundle with the lut as an explicit argument/return::

        loss, logits, new_lut = oim(lut, features, targets)
    """

    def __init__(self, num_features, num_classes, scalar=30.0, momentum=0.5):
        self.num_features = num_features
        self.num_classes = num_classes
        self.scalar = scalar
        self.momentum = momentum

    def init(self, device=None):
        return init_lut(self.num_classes, self.num_features, device=device)

    def __call__(self, lut, inputs, targets):
        logits = oim_logits(inputs, lut, self.scalar)
        loss = cross_entropy(logits, targets)
        new_lut = update_lut(lut, inputs, targets, self.momentum)
        return loss, logits, new_lut
