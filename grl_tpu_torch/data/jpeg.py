"""JPEG decode + resize for the loader's path sources (counterpart of
``grl_tpu/data/jpeg.py``).

The native routine ``grl_tpu_torch/csrc/jpeg_decoder.cpp`` (libjpeg, a copy
of grl_tpu's) is built with ``g++ ... -ljpeg`` at first use into
``build/host/`` at the root of the checkout (``.gitignore`` lists
``build/``); its file name carries a hash of the source, so an edited
source builds anew. It is called through ctypes, which releases the GIL,
so the loader's thread pool decodes concurrently. Where it cannot be built
(no compiler or no libjpeg headers) or it refuses a file (not a JPEG),
decoding falls back to PIL, exactly where grl_tpu's does.

The native resize is PIL's antialiased separable triangle filter in the
same 8.22 fixed point, so its output equals ``PIL.Image.resize(...,
BILINEAR)`` on up- and downscale.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "jpeg_decoder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"

_lock = threading.Lock()
_lib = None
# whether the native routine loaded, and why not when it did not
NATIVE_INFO = {"available": None, "error": None}


def _build():
    """Path of the built library, compiling it first when needed."""
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:10]
    so = BUILD_DIR / f"libgrljpeg-{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-ljpeg", "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed: {proc.stderr.strip()[-500:]}")
        os.replace(tmp, so)  # atomic: a concurrent builder never loads a partial file
    return so


def _load():
    global _lib
    with _lock:
        if NATIVE_INFO["available"] is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                lib.grl_decode_resize.restype = ctypes.c_int
                lib.grl_decode_resize.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                                  ctypes.c_int, ctypes.c_void_p]
                _lib = lib
                NATIVE_INFO["available"] = True
            except Exception as e:  # noqa: BLE001 - any build or load failure means PIL
                NATIVE_INFO.update(available=False, error=f"{type(e).__name__}: {e}")
        return NATIVE_INFO["available"]


def native_available():
    return _load()


def decode_pil(path, height, width):
    """PIL's decode of ``path`` to (height, width, 3) uint8, resized with
    ``Image.BILINEAR`` when the file is not that size."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if img.size != (width, height):
            img = img.resize((width, height), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)


def decode_route(path, height, width):
    """``(image, route)``: ``decode_resize``'s array and which routine made
    it, ``"native"`` or ``"PIL"``."""
    if _load():
        with open(path, "rb") as f:
            data = f.read()
        out = np.empty((height, width, 3), np.uint8)
        if _lib.grl_decode_resize(data, len(data), height, width, out.ctypes.data_as(ctypes.c_void_p)) == 0:
            return out, "native"
        # not a JPEG (e.g. PNG frames): PIL
    return decode_pil(path, height, width), "PIL"


def decode_resize(path, height, width):
    """Decode an image file to a (height, width, 3) uint8 array: the native
    routine when it is available and takes the file, PIL otherwise. Raises
    on undecodable input either way."""
    return decode_route(path, height, width)[0]
