"""Build the port's CUDA sources into a shared library at first use.

Each library is compiled by ``nvcc`` for ``sm_90a`` from the ``.cu`` files
under ``grl_tpu_torch/csrc/``, into ``build/kernels/`` at the root of the
checkout (``.gitignore`` lists ``build/``), and loaded with ``ctypes``. Its
file name carries a hash of its sources and flags, so an edited ``.cu``
builds anew. The sources have a plain C interface and include no PyTorch
header, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS = {}
# name -> {"seconds": build time (0.0 when the library was already built),
#          "log": nvcc's output, which holds -Xptxas -v's register counts}
BUILD_INFO = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build on a machine "
                           "with the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def load_library(name, sources):
    """Build (if needed) and load ``csrc/<sources>`` as one library."""
    if name in _LIBS:
        return _LIBS[name]
    paths = [CSRC / s for s in sources]
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    log = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a process building the same library never loads a partial file
    _LIBS[name] = ctypes.CDLL(str(so))
    BUILD_INFO[name] = {"seconds": seconds, "log": log.read_text() if log.exists() else ""}
    return _LIBS[name]
