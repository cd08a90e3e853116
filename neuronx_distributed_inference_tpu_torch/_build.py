"""Build and load the port's hand-written CUDA kernels (no counterpart in
the JAX package, whose Pallas kernels compile inside ``jax.jit``).

Each ``csrc/<name>.cu`` exposes a plain C interface; it is compiled with
``nvcc`` for ``sm_90a`` into ``_build/lib<name>-<hash>.so`` at first use
(the hash covers the source, the shared ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds)
and loaded with ``ctypes``. Nothing is built when the package is imported:
the CPU tests import every module on a machine with no ``nvcc``."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}
#: seconds spent compiling each kernel source in this process (0 when the
#: library was already built)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ with the CUDA toolkit's nvcc")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (content-addressed: the source,
    the ``csrc/*.cuh`` headers it may include, and the flags)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def nvcc_command(name: str, out: str) -> List[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC_DIR, name + ".cu")]


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library path. Raises ``RuntimeError`` with nvcc's output on failure."""
    lib = library_path(name)
    if os.path.exists(lib):
        BUILD_SECONDS.setdefault(name, 0.0)
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(nvcc_command(name, tmp), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(build(name))
        return lib
