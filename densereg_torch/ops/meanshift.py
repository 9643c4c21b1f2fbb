"""Weighted mean shift on CUDA: ``csrc/meanshift.cu``.

Replaces the TPU kernel
``densereg_tpu/ops/meanshift_pallas.py::weighted_mean_shift_pallas``. As in
the JAX package it is exported but on no serving path: the fused decode
(``ops.fused_decode``) runs the same stage inside its own kernel (both
include ``csrc/vote_meanshift.cuh``). The kernel is the custom op
``densereg::weighted_mean_shift``: on CUDA tensors it launches the
hand-written kernel (or raises); on CPU tensors it runs the plain version,
``decode.weighted_mean_shift``.
"""

from __future__ import annotations

import ctypes

import torch

from densereg_torch import decode
from densereg_torch.ops import _build

MAX_CANDIDATES = 8   # one candidate a lane of an 8-lane segment

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("meanshift")
    fn = lib.meanshift_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def weighted_mean_shift_cuda(cans, weights, num_it: int = 10,
                             band_width: float = 0.4,
                             grid: int = 4) -> torch.Tensor:
    """cans (b, j, n, 3) and weights (b, j, n), float32 -> (b, j, 3): the
    start at the last maximal cell of a grid^3 weighted vote, then
    ``num_it`` Gaussian mean-shift steps; an all-zero weight keeps the
    grid start.

    The custom op ``densereg::weighted_mean_shift``: on CUDA tensors it
    launches the kernel (or raises), on CPU tensors it runs
    ``decode.weighted_mean_shift``. Each launch of the kernel adds one to
    ``weighted_mean_shift_cuda.launches``.
    """
    impl = (_weighted_mean_shift_cuda if _build.eager(cans)
            else weighted_mean_shift_op)
    return impl(cans, weights, num_it, band_width, grid)


def _weighted_mean_shift_cuda(cans: torch.Tensor, weights: torch.Tensor,
                              num_it: int, band_width: float,
                              grid: int) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the kernel."""
    b, j, n, three = cans.shape
    if three != 3 or weights.shape != (b, j, n):
        raise ValueError(f"weighted_mean_shift_cuda: cans {tuple(cans.shape)}"
                         f" and weights {tuple(weights.shape)} are not "
                         f"(b, j, n, 3) and (b, j, n)")
    if cans.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("weighted_mean_shift_cuda: float32 only")
    dev = cans.device
    if weights.device != dev:
        raise ValueError("weighted_mean_shift_cuda: one device for both")
    if not 1 <= n <= MAX_CANDIDATES:
        raise ValueError(f"weighted_mean_shift_cuda: 1..{MAX_CANDIDATES} "
                         f"candidates, got {n}")
    out = torch.empty((b, j, 3), dtype=torch.float32, device=dev)
    if b * j == 0:
        return out
    cans = cans.contiguous()
    weights = weights.contiguous()
    args = (cans.data_ptr(), weights.data_ptr(), out.data_ptr(), b * j, n,
            num_it, -1.0 / (2.0 * band_width * band_width), grid,
            float(grid) - 0.1)
    launch = _lib().meanshift_launch
    if dev.index == torch.cuda.current_device():
        err = launch(*args, _build.stream(dev))
    else:
        with torch.cuda.device(dev):
            err = launch(*args, _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"weighted_mean_shift_cuda: kernel launch failed "
                           f"with cudaError_t {err}")
    weighted_mean_shift_cuda.launches += 1
    return out


weighted_mean_shift_op = torch.library.custom_op(
    "densereg::weighted_mean_shift", _weighted_mean_shift_cuda,
    mutates_args=(), device_types="cuda")


@weighted_mean_shift_op.register_kernel("cpu")
def _weighted_mean_shift_cpu(cans, weights, num_it, band_width, grid):
    return decode.weighted_mean_shift(cans, weights, num_it, band_width, grid)


@weighted_mean_shift_op.register_fake
def _weighted_mean_shift_fake(cans, weights, num_it, band_width, grid):
    b, j = cans.shape[:2]
    return cans.new_empty((b, j, 3), dtype=torch.float32)


weighted_mean_shift_cuda.launches = 0
