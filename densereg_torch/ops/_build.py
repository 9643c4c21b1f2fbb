"""Build the CUDA sources under ``densereg_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface; it is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``densereg_torch/_build/`` (git-ignored) on first use and loaded with
``ctypes``. The library's file name carries a hash of the source, of every
header it includes from ``csrc/`` (``#include "..."``, followed through
headers) and of the flags, so an edited source or header is rebuilt and
never served stale.

``--fmad=false`` keeps multiplies and adds apart, as the plain versions
compute them; ``--use_fast_math`` is deliberately absent. The decode
kernels add ``-ftz=true`` (:data:`SOURCE_FLAGS`): they flush subnormal
float32 values to zero, as XLA and their plain version do; K3 keeps IEEE
subnormals, as its plain version does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

# flags of one source on top of NVCC_FLAGS
SOURCE_FLAGS = {"fused_decode": ("-ftz=true",), "meanshift": ("-ftz=true",)}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

# the current stream's raw handle, without building a torch.cuda.Stream
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else the
    first ``nvcc`` on ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of densereg_torch "
                           "are built on first use and need the CUDA toolkit")
    return found


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def local_headers(path: Path) -> Iterable[Path]:
    """The headers that ``path`` includes with quotes, found beside it,
    and theirs in turn, each once, in the order first met."""
    seen: Dict[Path, None] = {}
    todo = [path]
    while todo:
        cur = todo.pop()
        for inc in _INCLUDE.findall(cur.read_bytes()):
            dep = (cur.parent / inc.decode()).resolve()
            if dep.is_file() and dep not in seen:
                seen[dep] = None
                todo.append(dep)
    return list(seen)


def flags(name: str):
    """The nvcc flags that ``csrc/<name>.cu`` is built with."""
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    src = sources()[name]
    digest = hashlib.sha256(src.read_bytes())
    for dep in local_headers(src):
        digest.update(dep.name.encode() + b"\0" + dep.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Raises on any failure with
    the compiler's output."""
    names = list(sources()) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [nvcc, *flags(n), "-o", str(tmp), str(sources()[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, paths[n])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]


def stream(device) -> int:
    """The raw handle of ``device``'s current CUDA stream, for a launch."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def eager(t: torch.Tensor) -> bool:
    """True where a wrapper calls its custom op's CUDA implementation
    itself: a CUDA tensor outside a trace (``torch.export``,
    ``torch.compile``). The op's dispatch, the route of a trace and of CPU
    tensors, costs tens of microseconds of host time a call and reaches
    the same function."""
    return t.is_cuda and not torch.compiler.is_compiling()
