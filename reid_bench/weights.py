"""The benchmark's weights, made on the device from the seed.

One ``torch.Generator`` on the device draws every leaf of the state dict
the system under test declares, one standard-normal draw for all of them
at once, then scaled leaf by leaf:

- convolutions and linear layers: He normal on their fan-in
  (``sqrt(2 / fan_in)``); the two-way verification classifiers
  ``N(0, 0.001)``, as the GRL reference initializes them; biases
  ``N(0, 0.01)``;
- BatchNorm: scale ``1 + N(0, 0.1)``, shift ``N(0, 0.1)``, running mean 0
  and variance 1; the last BatchNorm of each residual branch (the
  bottlenecks' and the TRL memory blocks' ``bn3``) scales by
  ``RESIDUAL_SCALE`` more, as trained residual networks keep those
  branches small. At scale 1 the random 50-layer trunk and the TRL
  recurrence amplify rounding so far that bf16's descriptor lies 0.2-0.8
  (relative) from fp32's, as far as float8's (on an NVIDIA H100).

``reference.grl.calibrate`` then sets every BatchNorm's running statistics from one
pass of the plain reference over seeded clips, so that the eval-mode
descriptor normalizes its activations as a trained network does (at
running statistics of 0 and 1 a deep random network maps every clip to
nearly the same descriptor).
"""

from __future__ import annotations

import math

import torch

RESIDUAL_SCALE = 0.1
STAT_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def generate(shapes, seed, device):
    """``shapes``: ``{name: (shape, dtype)}`` of a state dict -> ``{name:
    tensor}`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    floats = [(k, s) for k, (s, dt) in shapes.items() if dt.is_floating_point and not k.endswith(STAT_SUFFIXES)]
    total = sum(math.prod(s) for _, s in floats)
    draw = torch.randn(total, generator=gen, device=device)
    bn = {k[: -len(".running_mean")] for k in shapes if k.endswith(".running_mean")}
    out, offset = {}, 0
    for name, shape in floats:
        n = math.prod(shape)
        x = draw[offset : offset + n].view(shape)
        offset += n
        module, leaf = name.rsplit(".", 1)
        if module in bn:
            out[name] = (1.0 + 0.1 * x) * (RESIDUAL_SCALE if module.endswith(".bn3") else 1.0) \
                if leaf == "weight" else 0.1 * x
        elif leaf == "bias":
            out[name] = 0.01 * x
        elif module.endswith("classifierlinear"):
            out[name] = 0.001 * x
        else:
            fan_in = math.prod(shape[1:])
            out[name] = math.sqrt(2.0 / fan_in) * x
    for name, (shape, dtype) in shapes.items():
        if name.endswith(".running_mean") or name.endswith(".num_batches_tracked"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name.endswith(".running_var"):
            out[name] = torch.ones(shape, dtype=dtype, device=device)
    return out


def shapes_of(*prefixed_modules):
    """``{name: (shape, dtype)}`` of modules' state dicts, each name under
    its prefix: ``shapes_of(("cnn", cnn), ("siamese", siamese))``."""
    return {f"{prefix}.{k}": (tuple(v.shape), v.dtype)
            for prefix, module in prefixed_modules for k, v in module.state_dict().items()}


def load(w, *prefixed_modules):
    """Copy ``w`` into the modules (strictly: every leaf, nothing more)."""
    for prefix, module in prefixed_modules:
        sub = {k[len(prefix) + 1 :]: v for k, v in w.items() if k.startswith(prefix + ".")}
        module.load_state_dict(sub, strict=True)
