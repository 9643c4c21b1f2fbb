"""ctypes binding for the native depthio codec (native/depthio.cc), the
port's copy of ``densereg_tpu/data/native.py``.

Compiles ``native/depthio.cc`` on demand with ``g++`` (zlib only) into the
port's git-ignored ``densereg_torch/_build/``, under a name that carries a
hash of the source and of the flags, and falls back to the PIL path in
:mod:`densereg_torch.data.png16` when the compiler or zlib is missing, so
callers never need to care. The library is written to a temporary file and
renamed into place, so no process, of this package or another, ever opens a
half-written one, however many build it at once; the shared
``native/libdepthio.so`` of the JAX package is never written. The batch API
decodes frames on a C++ thread pool with the GIL released (ctypes drops it
for the call), which is what the single-threaded PIL loop in the converters
cannot do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_ROOT), "native", "depthio.cc")
_BUILD_DIR = os.path.join(_ROOT, "_build")
# native/Makefile's flags and libraries
_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
_LIBS = ("-lz", "-lpthread")

_lib = None
_lock = threading.Lock()
_build_failed = False


def library_path() -> str:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256()
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    digest.update(" ".join(_CXX_FLAGS + _LIBS).encode())
    return os.path.join(_BUILD_DIR, f"libdepthio-{digest.hexdigest()[:16]}.so")


def _build() -> str:
    """The library's path, compiled first where it is missing: to a
    temporary file of this process, then renamed into place (atomic)."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            subprocess.run([os.environ.get("CXX", "g++"), *_CXX_FLAGS,
                            _SOURCE, "-o", tmp, *_LIBS], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.depthio_decode_png.restype = ctypes.c_int
        lib.depthio_decode_png.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.depthio_decode_png_batch.restype = ctypes.c_int
        lib.depthio_decode_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_png16(data: bytes, h: int, w: int,
                 nyu_packed: bool = False) -> Optional[np.ndarray]:
    """Decode one PNG; returns None if the native lib is unavailable (caller
    falls back to PIL)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((h, w), np.uint16)
    rc = lib.depthio_decode_png(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, int(nyu_packed))
    if rc != 0:
        raise ValueError(f"depthio decode failed with code {rc}")
    return out


def decode_png16_batch(blobs: List[bytes], h: int, w: int,
                       nyu_packed: bool = False,
                       num_threads: int = 0) -> Optional[np.ndarray]:
    """Decode a list of PNG byte strings into (n, h, w) uint16 using the C++
    thread pool.  Returns None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(blobs)
    out = np.empty((n, h, w), np.uint16)
    arr_t = ctypes.c_char_p * n
    size_t = ctypes.c_size_t * n
    datas = arr_t(*blobs)
    sizes = size_t(*[len(b) for b in blobs])
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, 8)
    rc = lib.depthio_decode_png_batch(
        datas, sizes, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, int(nyu_packed), num_threads)
    if rc != 0:
        raise ValueError(f"depthio batch decode failed with code {rc}")
    return out
