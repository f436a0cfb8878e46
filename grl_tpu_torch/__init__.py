"""PyTorch/CUDA port of grl_tpu: video person re-ID on an NVIDIA H100.

The JAX package ``grl_tpu`` is the reference; this package imports torch,
numpy and the standard library only — never ``jax`` and nothing of
``grl_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``; a machine without CUDA raises instead of quietly
running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None):
    """``device`` (None means ``"cuda"``) -> ``torch.device``.

    Raises when a CUDA device is asked for and none is present: the port's
    entry points never fall back to the CPU on their own.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "grl_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return device


__all__ = ["resolve_device"]
