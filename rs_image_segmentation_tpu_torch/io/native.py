"""ctypes binding to the native strip/tile codec (``native/tiffcodec.cpp``).

Counterpart of ``rs_image_segmentation_tpu.io.native``. At first use the
codec builds with ``g++`` from the repository's ``native/tiffcodec.cpp``
into the port's ``_build/`` (listed in ``.gitignore``), under a name that
carries a hash of the source and flags, so an edited source never loads
a stale build; nothing is written under ``native/``. Every entry point
returns None when the library cannot be built or loaded, and the callers
(``io.tiff``, ``pipeline.preprocess.build_stretch_stats``) take their
pure-Python or numpy versions: host code either way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "tiffcodec.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where ``native/tiffcodec.cpp`` builds to."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtiffcodec-{digest[:16]}.so"


def _build(target: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        os.unlink(tmp)
        return False
    os.replace(tmp, target)     # atomic: a reader never sees half a file
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for name in ("lzw_decode", "lzw_encode", "packbits_decode"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                       ctypes.c_long]
    for name in ("predictor_undo", "predictor_apply"):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                       ctypes.c_long, ctypes.c_int]
    lib.hist_u8.restype = None
    lib.hist_u8.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The codec library, built on first use; None when it cannot be
    built or loaded. Safe to call from several threads at once."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if not SOURCE.exists():
            return None
        target = library_path()
        if not target.exists() and not _build(target):
            return None
        try:
            _LIB = _bind(ctypes.CDLL(str(target)))
        except (OSError, AttributeError):
            _LIB = None
        return _LIB


def available() -> bool:
    return _load() is not None


def hist_u8(arr: np.ndarray) -> Optional[np.ndarray]:
    """Exact 256-bin histogram of a uint8 array (int64 counts). None if
    the library is unavailable (callers then take ``np.bincount``)."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(arr.reshape(-1))
    if a.dtype != np.uint8:
        raise ValueError(f"hist_u8 wants uint8, got {a.dtype}")
    out = np.zeros(256, dtype=np.int64)
    lib.hist_u8(a.ctypes.data, a.size, out.ctypes.data)
    return out


def lzw_decode(data: bytes, expected_size: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(expected_size, dtype=np.uint8)
    n = lib.lzw_decode(data, len(data), out.ctypes.data, expected_size)
    if n < 0:
        raise ValueError("corrupt LZW stream")
    return out[:n].tobytes()


def lzw_encode(data: bytes) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    # worst case: 12 bits per input byte plus framing
    cap = len(data) * 2 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = lib.lzw_encode(data, len(data), out.ctypes.data, cap)
    if n < 0:
        raise ValueError("LZW encode overflow")
    return out[:n].tobytes()


def packbits_decode(data: bytes, expected_size: int) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    out = np.empty(max(expected_size, 1), dtype=np.uint8)
    n = lib.packbits_decode(data, len(data), out.ctypes.data, expected_size)
    if n < 0:
        raise ValueError("corrupt PackBits stream")
    return out[:n].tobytes()
