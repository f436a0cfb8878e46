"""Hand-written Hopper kernels, each beside its plain PyTorch version.

``KERNELS`` names every kernel wrapper; each wrapper counts its launches
in ``wrapper.launches``.
"""

from .minplus import minplus, minplus_plain, padded_empty

KERNELS = {"minplus": minplus}

__all__ = ["KERNELS", "minplus", "minplus_plain", "padded_empty"]
