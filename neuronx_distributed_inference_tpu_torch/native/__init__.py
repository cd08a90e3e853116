"""Native (C++) host-runtime components, loaded with ``ctypes``
(counterpart: ``neuronx_distributed_inference_tpu/native/__init__.py``,
whose C API :56-96 this keeps).

The port compiles its own copy of the source (``block_allocator.cpp``
here, with a salt seed added) with ``g++ -O2 -std=c++17 -shared -fPIC``
at first use into the package's git-ignored ``_build/``, under a name
hashed from the source and the flags: an edited source builds anew, and
processes that build at once (test workers) each write a temporary file
and move it into place. Nothing is built when the package is imported.
Set ``NXDI_TPU_NATIVE=0`` to use the Python fallbacks."""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from typing import Optional

logger = logging.getLogger("nxdi_tpu")

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
SOURCES = ("block_allocator.cpp",)
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: why the library is unavailable (the build's error), None while it is
#: not known to have failed
load_error: Optional[str] = None


def native_enabled() -> bool:
    return os.environ.get("NXDI_TPU_NATIVE", "1") not in ("0", "false")


def library_path() -> str:
    """Where the sources build to (content-addressed: sources and flags)."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(_DIR, name), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libnxdi_native-{digest.hexdigest()[:16]}.so")


def _compile(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS,
                        *(os.path.join(_DIR, s) for s in SOURCES),
                        "-o", tmp], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, path)
        logger.info("native: built %s", path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_int, p_int = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    p_i64, p_u8 = ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p
    sigs = {
        "nxdi_alloc_create": (ctypes.c_void_p, [c_int, c_int, c_int]),
        "nxdi_alloc_destroy": (None, [ctypes.c_void_p]),
        "nxdi_alloc_allocate": (c_int, [ctypes.c_void_p, p_i64, c_int,
                                        p_int, c_int, p_int]),
        "nxdi_alloc_allocate_salted": (c_int, [
            ctypes.c_void_p, p_i64, c_int, p_int, c_int, p_int, p_u8,
            c_int]),
        "nxdi_alloc_extend": (c_int, [ctypes.c_void_p, p_int, c_int, c_int,
                                      c_int]),
        "nxdi_alloc_free": (c_int, [ctypes.c_void_p, p_int, c_int]),
        "nxdi_alloc_invalidate": (c_int, [ctypes.c_void_p, p_int, c_int]),
        "nxdi_alloc_num_free": (c_int, [ctypes.c_void_p]),
        "nxdi_alloc_probe": (c_int, [ctypes.c_void_p, p_i64, c_int, p_int,
                                     c_int]),
        "nxdi_alloc_probe_salted": (c_int, [ctypes.c_void_p, p_i64, c_int,
                                            p_int, c_int, p_u8, c_int]),
        "nxdi_alloc_set_prefix_caching": (None, [ctypes.c_void_p, c_int]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once per source) and load the native library; None when
    disabled or when the build failed (:data:`load_error` says why):
    callers fall back to the Python implementations."""
    global _lib, load_error
    if not native_enabled() or load_error is not None:
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None and load_error is None:
            try:
                path = library_path()
                if not os.path.exists(path):
                    _compile(path)
                _lib = _bind(ctypes.CDLL(path))
            except (OSError, AttributeError, subprocess.SubprocessError) as e:
                err = getattr(e, "stderr", b"") or b""
                load_error = f"{e} {err.decode(errors='replace')}".strip()
        return _lib
