"""Build the CUDA sources under ``densereg_torch/csrc``, load them, and
launch their kernels: the one launch seam of the port's hand-written kernels.

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
subnormals, as its plain version does. The depthwise and the quantize
kernels are built with ``-Xptxas -v``: the compiler's output (registers,
spills, shared memory of each kernel) is kept beside the library
(:func:`build_log`).

Each wrapper under ``ops/`` launches its kernel through a :class:`Kernel`
and registers its custom op through an :class:`Op`.
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
SOURCE_FLAGS = {"fused_decode": ("-ftz=true",), "meanshift": ("-ftz=true",),
                "int8_dwconv": ("-Xptxas", "-v"),
                "int8_quantize": ("-Xptxas", "-v")}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

# a device index's current stream, raw, without a torch.cuda.Stream object
_raw_stream = (getattr(torch._C, "_cuda_getCurrentRawStream", None)
               or (lambda index: torch.cuda.current_stream(index).cuda_stream))


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
            paths[n].with_suffix(".log").write_text(log)
            os.replace(tmp, paths[n])  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> Optional[str]:
    """What nvcc printed when it built ``csrc/<name>.cu`` (None if this
    checkout has not built it)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else None


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(build([name])[name]))
        return _loaded[name]


class Kernel:
    """The C entry ``entry`` of ``csrc/<source>.cu``, bound to ``argtypes``
    on the first launch. Every entry returns a ``cudaError_t`` and takes the
    raw stream last, after an ``int*`` for the path it took where it has
    ``paths``. A launch adds one to ``counter.launches`` and to
    ``counter.launches_by_path[path]`` (like them, the one path int is not
    kept apart for two threads), one recorded into a CUDA graph's capture
    too: a replay of the graph makes no call and counts nothing here. An
    error raises ``RuntimeError`` named after ``counter``, with
    ``notes[err]`` appended."""

    def __init__(self, source: str, entry: str, argtypes, counter,
                 paths=None, notes=None):
        self.source, self.entry = source, entry
        self.argtypes = list(argtypes)
        self.tail = ()
        if paths:
            self.argtypes.append(ctypes.POINTER(ctypes.c_int))
            self.path = ctypes.c_int(-1)
            self.tail = (ctypes.byref(self.path),)
        self.argtypes.append(ctypes.c_void_p)
        self.counter, self.paths, self.notes = counter, paths, notes or {}
        self._fn = None
        counter.launches = 0
        if paths:
            counter.launches_by_path = dict.fromkeys(paths, 0)

    def __call__(self, device: torch.device, args: tuple) -> None:
        """Launch with ``args`` on ``device``'s current stream, entering the
        device only where it is not the current one."""
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(load(self.source), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
        if device.index == torch.cuda.current_device():
            err = fn(*args, *self.tail, _raw_stream(device.index))
        else:
            with torch.cuda.device(device):
                err = fn(*args, *self.tail, _raw_stream(device.index))
        if err:
            raise RuntimeError(f"{self.counter.__name__}: kernel launch "
                               f"failed with cudaError_t {err}"
                               + self.notes.get(err, ""))
        counter = self.counter
        counter.launches += 1
        if self.paths:
            counter.launches_by_path[self.paths[self.path.value]] += 1


class Op:
    """A kernel's ``torch.library`` custom op ``densereg::<name>``: ``cuda``
    (the kernel's launch) on CUDA tensors, ``cpu`` (its plain form) on CPU
    tensors, ``fake`` (the outputs' shapes, dtypes and strides) in a trace;
    ``cuda``'s annotations give the op's schema."""

    def __init__(self, name: str, cuda, cpu, fake):
        self.cuda = cuda
        self.op = torch.library.custom_op(f"densereg::{name}", cuda,
                                          mutates_args=(),
                                          device_types="cuda")
        self.op.register_kernel("cpu", cpu)
        self.op.register_fake(fake)

    def impl_for(self, t: torch.Tensor):
        """What a wrapper calls for its first tensor ``t``: ``cuda`` itself
        for a CUDA tensor outside a trace (``torch.export``,
        ``torch.compile``), since the op's dispatch costs tens of
        microseconds of host time a call and reaches the same function;
        else the op."""
        if t.is_cuda and not torch.compiler.is_compiling():
            return self.cuda
        return self.op
