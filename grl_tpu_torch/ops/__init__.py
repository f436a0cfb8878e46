"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``KERNELS`` names every kernel wrapper; each wrapper counts its launches
in ``wrapper.launches``.
"""

from .minplus import minplus, minplus_plain, padded_empty
from .nearest import nearest_k, nearest_plain

KERNELS = {"minplus": minplus, "nearest": nearest_k}

__all__ = ["KERNELS", "minplus", "minplus_plain", "nearest_k", "nearest_plain", "padded_empty"]
