"""Fresh weights with grl_tpu's init distributions (``grl_tpu/nn/init.py``),
drawn from a ``torch.Generator``.

The distributions match, the draws do not: grl_tpu uses ``jax.random``.
Parity tests therefore load grl_tpu's own init through the weight bridge
instead of comparing fresh inits.

Every ``nn.Conv2d``/``nn.Linear`` takes torch's default rule
(kaiming-uniform with a=sqrt(5) on fan-in, bias uniform ±1/sqrt(fan_in)),
which is grl_tpu's default too, unless the layer carries an ``init_rule``
attribute:

- ``"resnet_normal"``: normal(0, sqrt(2 / (kh·kw·cout))), the trunk convs;
- ``"kaiming_fan_out"``: kaiming-uniform (a=0) on fan-out, zero bias, the
  Siamese Q/K/V projections;
- ``"classifier"``: normal(0, 0.001), zero bias.

BatchNorm layers get scale 1, bias 0, running mean 0 and running var 1.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def _fans(weight):
    # torch layouts: conv (out, in, kh, kw), linear (out, in)
    rf = weight[0, 0].numel() if weight.dim() > 2 else 1
    return weight.shape[1] * rf, weight.shape[0] * rf


def _uniform(t, bound, g):
    t.uniform_(-bound, bound, generator=g)


@torch.no_grad()
def init_weights(module, generator):
    """Re-initialize every conv, linear and BN layer under ``module``."""
    g = generator
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            rule = getattr(m, "init_rule", None)
            fan_in, fan_out = _fans(m.weight)
            if rule == "resnet_normal":
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
            elif rule == "kaiming_fan_out":
                _uniform(m.weight, math.sqrt(3.0) * math.sqrt(2.0) / math.sqrt(fan_out), g)
            elif rule == "classifier":
                m.weight.normal_(0.0, 0.001, generator=g)
            else:
                gain = math.sqrt(2.0 / (1.0 + 5.0))
                _uniform(m.weight, math.sqrt(3.0) * gain / math.sqrt(fan_in), g)
            if m.bias is not None:
                if rule in ("kaiming_fan_out", "classifier"):
                    m.bias.zero_()
                else:
                    _uniform(m.bias, 1.0 / math.sqrt(fan_in), g)
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
