"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, from the package's own sources, into ``_build/`` beside ``csrc/``
(listed in ``.gitignore``); the library name carries a hash of the source
and of the flags that source gets, so an edited source or flag never
loads a stale build. Nothing here runs at import time, so the package
imports on hosts without ``nvcc``.

Flags per source. Every source gets ``NVCC_FLAGS``. The sources in
``NO_FMA`` (``stretch_indices``, ``glcm`` and ``kmeans_lloyd``) compute in
floating point and are held to plain PyTorch versions that round every
product, so they also get ``--fmad=false``: nvcc would otherwise contract
``a*b + c`` into one FMA. A new floating-point source held to a plain version joins
``NO_FMA``. No source gets ``-use_fast_math``: nvcc's defaults
``-prec-div=true`` and ``-prec-sqrt=true`` keep ``/`` and ``sqrtf`` IEEE
correctly rounded, as PyTorch's are.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("lut_hist", "forest_labels", "ccmin_prop", "hist_keep",
           "stretch_indices", "glcm", "kmeans_lloyd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
NO_FMA = ("stretch_indices", "glcm", "kmeans_lloyd")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def flags(name: str) -> tuple:
    """The nvcc flags ``csrc/<name>.cu`` builds with."""
    return NVCC_FLAGS + (("--fmad=false",) if name in NO_FMA else ())


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns per kernel the build seconds
    (0.0 when already built) and the compiler's resource report."""
    jobs = {}
    report = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "ptxas": ""}
            continue
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, target)
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, target)     # atomic: a reader never sees half a file
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.
    Safe from several threads at once (a serving engine's dispatch thread
    and a warm-up in its caller's): one of them builds, the others wait."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                target = library_path(name)
                if not target.exists():
                    build([name])
                lib = _LIBS[name] = ctypes.CDLL(str(target))
    return lib
