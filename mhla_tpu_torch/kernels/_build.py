"""Build and load the CUDA kernels of ``mhla_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain C
interface, which ``ctypes`` loads. The library is built at first use into
``mhla_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of the sources and flags, so an edited source builds anew and an
unchanged one loads at once. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills, kept in the build log
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmhla_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; return its path. The compiler's
    output (``-Xptxas=-v``) is kept beside it as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    sources = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    res = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
    return _lib
