"""int8 GEMM with the requantisation epilogue fused: ``csrc/int8_gemm.cu``.

Replaces the TPU kernel ``densereg_tpu/ops/int8_gemm.py::int8_gemm_requant``
and, unlike it, takes any M, N and K. On CUDA tensors
:func:`int8_gemm_requant` launches the hand-written kernel (or raises); on
CPU tensors it runs :func:`int8_gemm_requant_reference`, the plain torch
form that is the kernel's oracle.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from densereg_torch.ops import _build

# |acc| <= 127 * 127 * K must fit in int32
MAX_K = (2 ** 31 - 1) // (127 * 127)
F_KINDS = {torch.float32: 1, torch.bfloat16: 2}

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
              ctypes.c_longlong] + [ctypes.c_void_p] * 4
             + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_gemm")
    fn = lib.int8_gemm_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def quantize(xf: torch.Tensor, s: torch.Tensor,
             pitch16: bool = False) -> torch.Tensor:
    """``clip(round(xf / s), -127, 127)`` as int8, with ``s`` a 0-d float32
    tensor on ``xf``'s device. Dividing by a tensor (not by a Python number,
    which PyTorch's CUDA kernels turn into a multiply by the reciprocal)
    keeps the division IEEE on the card, so the card and the CPU round to
    the same int8 step. ``pitch16`` returns a view whose rows (the last
    axis) start every ``ceil(C / 16) * 16`` bytes, as the kernel's ``q``."""
    r = torch.clamp(torch.round(xf.float() / s), -127, 127)
    c = r.shape[-1]
    if not pitch16 or c % 16 == 0:
        return r.to(torch.int8)
    out = torch.empty(r.shape[:-1] + (-(-c // 16) * 16,), dtype=torch.int8,
                      device=r.device)[..., :c]
    return out.copy_(r)


def int8_gemm_requant_reference(x_q, w_q, scale, bias, s_y=None, *,
                                relu: bool = True, emit_q: bool = True,
                                emit_f: bool = False,
                                f_dtype=torch.bfloat16
                                ) -> Tuple[Optional[torch.Tensor],
                                           Optional[torch.Tensor]]:
    """Plain form of :func:`int8_gemm_requant`. The int32 sums are exact:
    an int64 product on the CPU; a float64 one on the card, which has no
    integer matmul (|acc| <= 127^2 * K < 2^53)."""
    if x_q.is_cuda:
        acc = x_q.double() @ w_q.double()
    else:
        acc = x_q.long() @ w_q.long()
    y = acc.float() * scale.float()
    y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    q = quantize(y, _as_scale(s_y, y.device)) if emit_q else None
    f = y.to(f_dtype) if emit_f else None
    return q, f


def _as_scale(s_y, device) -> torch.Tensor:
    """``s_y`` as a 0-d float32 tensor on ``device``."""
    if s_y is None:
        raise ValueError("int8_gemm_requant: emit_q needs s_y")
    if not isinstance(s_y, torch.Tensor):
        return torch.full((), float(s_y), dtype=torch.float32, device=device)
    return s_y.reshape(()).to(device=device, dtype=torch.float32)


def _check(x_q, w_q, scale, bias, emit_q, emit_f, f_dtype):
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_gemm_requant: x {tuple(x_q.shape)} and w "
                         f"{tuple(w_q.shape)} are not (M, K) and (K, N)")
    m, k = x_q.shape
    n = w_q.shape[1]
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("int8_gemm_requant: x and w must be int8")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"int8_gemm_requant: {name} must be ({n},) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    for t in (w_q, scale, bias):
        if t.device != x_q.device:
            raise ValueError("int8_gemm_requant: all operands on one device")
    if not 1 <= k <= MAX_K or m < 1 or n < 1:
        raise ValueError(f"int8_gemm_requant: M, N >= 1 and 1 <= K <= "
                         f"{MAX_K}, got M={m} K={k} N={n}")
    if not (emit_q or emit_f):
        raise ValueError("int8_gemm_requant: need emit_q or emit_f")
    if emit_f and f_dtype not in F_KINDS:
        raise TypeError(f"int8_gemm_requant: f_dtype must be float32 or "
                        f"bfloat16, got {f_dtype}")


def int8_gemm_requant(x_q, w_q, scale, bias, s_y=None, *, relu: bool = True,
                      emit_q: bool = True, emit_f: bool = False,
                      f_dtype=torch.bfloat16):
    """``y = relu?((x_q @ w_q) * scale + bias)`` with int32 sums; returns
    ``(q, f)``: ``q = clip(round(y / s_y), -127, 127)`` int8 and ``f = y``
    in ``f_dtype`` (float32 or bfloat16), the one not asked for None.

    x_q (M, K) int8 and w_q (K, N) int8, any M, N, K; scale and bias (N,)
    float32 (``scale = s_x * s_w``); s_y a 0-d float32 tensor (or a number)
    on the same device. On the card, w_q is read as its (N, K) transpose:
    pass a (K, N) view of a K-contiguous tensor (``w.t()`` of an (N, K)
    one), else it is copied so. ``q`` comes back as an (M, N) view whose
    rows start every ``ceil(N / 16) * 16`` bytes, so that a following GEMM
    reads them 16 bytes at a time.

    Each launch of the kernel adds one to ``int8_gemm_requant.launches``.
    """
    if not x_q.is_cuda:
        return int8_gemm_requant_reference(
            x_q, w_q, scale, bias, s_y, relu=relu, emit_q=emit_q,
            emit_f=emit_f, f_dtype=f_dtype)
    _check(x_q, w_q, scale, bias, emit_q, emit_f, f_dtype)
    m, k = x_q.shape
    n = w_q.shape[1]
    if x_q.stride(1) != 1:
        x_q = x_q.contiguous()
    if w_q.stride(0) != 1:
        w_q = w_q.t().contiguous().t()
    scale = scale.contiguous()
    bias = bias.contiguous()
    dev = x_q.device
    q = f = None
    sy_ptr = q_ptr = f_ptr = None
    ldq = ldf = 0
    if emit_q:
        s_y = _as_scale(s_y, dev)
        ldq = -(-n // 16) * 16
        q = torch.empty((m, ldq), dtype=torch.int8, device=dev)[:, :n]
        sy_ptr, q_ptr = s_y.data_ptr(), q.data_ptr()
    if emit_f:
        f = torch.empty((m, n), dtype=f_dtype, device=dev)
        f_ptr, ldf = f.data_ptr(), n
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.int8_gemm_launch(
            x_q.data_ptr(), x_q.stride(0), w_q.data_ptr(), w_q.stride(1),
            scale.data_ptr(), bias.data_ptr(), sy_ptr, q_ptr, ldq, f_ptr, ldf,
            F_KINDS[f_dtype] if emit_f else 0, m, n, k, int(relu),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm_requant: kernel launch failed with "
                           f"cudaError_t {err}")
    int8_gemm_requant.launches += 1
    return q, f


int8_gemm_requant.launches = 0
