"""SGD with per-group learning-rate multipliers (counterpart of
``grl_tpu/engine/optim.py``).

The reference trains with ``SGD(lr, momentum=0.9, weight_decay=5e-4,
nesterov=True)``; the GCE backbone (trunk included) takes ``lr_mult`` 1 and
every other module 2, and the base lr steps by ``0.1 ** (epoch // 15)``.
grl_tpu writes this as optax ``add_decayed_weights`` followed by
``trace(nesterov=True)``; ``torch.optim.SGD`` with ``dampening=0`` is the
same arithmetic (weight decay added to the raw gradient, then the momentum
trace), and its ``momentum_buffer`` is optax's trace.
"""

from __future__ import annotations

import torch


def lr_mult_tree(named_parameters, rules, default=1.0):
    """``{name: multiplier}``: ``rules`` maps dotted name prefixes to
    multipliers; the longest matching prefix wins."""
    mults = {}
    for name, _ in named_parameters:
        best, best_len = default, -1
        for prefix, m in rules.items():
            if (name + ".").startswith(prefix + ".") and len(prefix) > best_len:
                best, best_len = m, len(prefix)
        mults[name] = best
    return mults


class SGD(torch.optim.SGD):
    """Nesterov SGD with one param group per lr multiplier.

    ``set_lr(lr)`` sets every group's lr to ``lr * lr_mult``.
    """

    def __init__(self, named_parameters, mults, momentum=0.9, weight_decay=5e-4, nesterov=True):
        groups = {}
        for name, p in named_parameters:
            groups.setdefault(mults[name], []).append(p)
        super().__init__(
            [{"params": ps, "lr_mult": m} for m, ps in groups.items()],
            lr=0.0, momentum=momentum, dampening=0.0, weight_decay=weight_decay, nesterov=nesterov,
        )

    def set_lr(self, lr):
        for group in self.param_groups:
            group["lr"] = lr * group["lr_mult"]


def step_decay_lr(base_lr, epoch, step_size=15, gamma=0.1):
    """lr = base * gamma^(epoch // step_size)."""
    return base_lr * (gamma ** (epoch // step_size))
