"""The card's data-sheet peaks (NVIDIA H100 SXM5, 700 W, dense: no
sparsity) and the kernel names that count as the products' work.

The name rules are the system's profile tool's convolution and GEMM
categories (``tools/profile_train_step.py``), copied: cuDNN's
implicit-GEMM, Winograd and FFT kernels and its layout changes around
them, and cuBLAS/cuBLASLt/CUTLASS GEMMs. The two are counted together:
cuDNN runs some 1x1 convolutions as cuBLASLt GEMMs (``nvjet`` kernels),
which a kernel's name cannot tell apart from a linear layer's.
"""

import re

PEAK_BF16_OPS = 989e12
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

_CONV = re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm|nchwToNhwc|nhwcToNchw|winograd|fft"
                   r"|pointwise_mult_and_sum_complex|im2col|col2im", re.I)
_GEMM = re.compile(r"gemm|gemv|nvjet|cublas|cutlass|splitKreduce|matmul", re.I)
_NOT = re.compile(r"batch_?norm|bn_fw|bn_bw|minplus", re.I)


def is_product_kernel(name):
    """Whether a device kernel's name is a convolution's or a GEMM's
    (normalization kernels, which a name may share a word with, and the
    min-plus kernel are not)."""
    return not _NOT.search(name) and bool(_CONV.search(name) or _GEMM.search(name))
