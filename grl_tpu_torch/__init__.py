"""PyTorch/CUDA port of grl_tpu: video person re-ID on an NVIDIA H100.

The JAX package ``grl_tpu`` is the reference; this package imports torch,
numpy and the standard library only — never ``jax`` and nothing of
``grl_tpu``. Entry points run on the card unless the caller passes
``device="cpu"``; a machine without CUDA raises instead of quietly
running on the CPU. The CLIs fix the precision policy at entry
(``set_precision``): fp32 means fp32, bf16 is asked for with ``--bf16``.
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


# the process-wide flags of the precision policy, by name: each is off
# under it
_PRECISION_FLAGS = {
    "cudnn.allow_tf32": (torch.backends.cudnn, "allow_tf32"),
    "matmul.allow_tf32": (torch.backends.cuda.matmul, "allow_tf32"),
    "matmul.allow_bf16_reduced_precision_reduction": (torch.backends.cuda.matmul,
                                                      "allow_bf16_reduced_precision_reduction"),
}


def precision_flags():
    """The precision policy's flags as they stand: ``{name: bool}``."""
    return {name: bool(getattr(obj, attr)) for name, (obj, attr) in _PRECISION_FLAGS.items()}


def set_precision_flags(flags):
    """Set the policy's flags from ``{name: bool}`` (as ``precision_flags``
    returns them); a name that is not one of them raises."""
    for name, value in flags.items():
        obj, attr = _PRECISION_FLAGS[name]
        setattr(obj, attr, value)


def set_precision():
    """The entry points' precision policy: fp32 convolutions and matrix
    products run in full fp32, TF32 off in cuDNN and cuBLAS (PyTorch's
    default puts cuDNN convolutions in TF32). Reduced precision is bf16,
    asked for with ``compute_dtype`` (``--bf16``) and nothing else, and its
    products accumulate in fp32, as grl_tpu's do (cuBLAS may otherwise
    reduce bf16 partial sums in bf16). Sets process-wide flags, so only a
    CLI ``main`` calls it."""
    set_precision_flags(dict.fromkeys(_PRECISION_FLAGS, False))


__all__ = ["precision_flags", "resolve_device", "set_precision", "set_precision_flags"]
