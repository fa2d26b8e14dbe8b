"""Build and load the CUDA kernels of ``mhla_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` into an object file, one process per
source, all started together, and links them into one shared library with a
plain C interface, which ``ctypes`` loads. The library is built at first use into
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    sources = sorted(CSRC_DIR.glob("*.cu"))
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    logs = [f"== {src.name}\n{p.communicate()[0]}" for src, p in zip(sources, procs)]
    failed = [src.name for src, p in zip(sources, procs) if p.returncode != 0]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    if not failed:
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True,
        )
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode != 0:
            failed.append("link")
    so.with_suffix(".log").write_text("\n".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
    return _lib
