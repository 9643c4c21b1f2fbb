"""Depthwise int8 convolution with the requantisation epilogue fused:
``csrc/int8_dwconv.cu``.

The port's own kernel, in K3's family. It has no Pallas counterpart: the
JAX package runs the depthwise convolutions of the ``um_v1_lite`` int8 net
as XLA's grouped int8 convolution (``densereg_tpu/models/layers.py:237-244``,
``feature_group_count`` = C), which torch lacks on CUDA, and K3 takes no
groups. :func:`int8_dwconv_requant` calls the custom op
``densereg::int8_dwconv_requant``, which launches the hand-written kernel
on CUDA tensors (or raises) and runs its plain version,
:func:`int8_dwconv_requant_reference`, on CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from densereg_torch.ops import _build
from densereg_torch.ops.int8_gemm import (
    F_KINDS,
    _aligned,
    _as_scale,
    _emitted,
    _filled,
    _outputs,
    _pad16,
    requant_reference,
    same_pads,
)

# window sizes the kernel is built for (its weights live in registers)
KERNEL_SIZES = (1, 3, 5)

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
             + [ctypes.c_int] * 3 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_dwconv")
    fn = lib.dw_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def pack_dw_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """A depthwise HWIO int8 kernel ``(k, k, 1, C)`` -> the kernel's
    ``(k * k, Cp)`` operand, ``Cp = ceil(C / 16) * 16``, taps in (kh, kw)
    order, zeros at the padded channels: what an activation's pitch bytes
    meet, so they add exactly 0."""
    kh, kw, one, c = kernel_q.shape
    if kh != kw or one != 1:
        raise ValueError(f"pack_dw_weight: {tuple(kernel_q.shape)} is not a "
                         f"depthwise (k, k, 1, C) kernel")
    w = kernel_q.new_zeros((kh * kw, _pad16(c)))
    w[:, :c] = kernel_q.reshape(kh * kw, c)
    return w


def _taps(w_packed: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """The ``(k, k, C)`` taps of a :func:`pack_dw_weight` operand."""
    return w_packed[:, :c].reshape(k, k, c)


def int8_dwconv_requant_reference(x_q, w_packed, k: int, scale, bias,
                                  s_y=None, **kw):
    """Plain form of :func:`int8_dwconv_requant`: the int32 sum over the
    k x k shifted slices of the zero-padded input, then
    ``int8_gemm.requant_reference``."""
    b, h, w, c = x_q.shape
    taps = _taps(w_packed, k, c).int()
    ph, pw = same_pads(h, k, 1), same_pads(w, k, 1)
    xp = torch.zeros((b, h + sum(ph), w + sum(pw), c), dtype=torch.int32,
                     device=x_q.device)
    xp[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w] = x_q
    acc = torch.zeros((b, h, w, c), dtype=torch.int32, device=x_q.device)
    for i in range(k):
        for j in range(k):
            acc += xp[:, i:i + h, j:j + w] * taps[i, j]
    return requant_reference(acc, scale, bias, s_y, **kw)


def int8_dwconv_requant(x_q, w_packed, k: int, scale, bias, s_y=None, *,
                        relu: bool = True, emit_q: bool = True,
                        emit_f: bool = False, f_dtype=torch.bfloat16):
    """The depthwise k x k SAME stride-1 convolution of the NHWC int8
    ``x_q`` (b, h, w, C), any C and any strides, with the taps of
    :func:`pack_dw_weight` ``w_packed`` (k * k, Cp), then K3's epilogue
    (``int8_gemm.int8_gemm_requant``'s arguments and checks): returns
    ``(q, f)`` as ``(b, h, w, C)``; on the card ``q``'s pixels lie ``Cp``
    bytes apart, as K3 and ``int8_gemm.quantize(pitch16=True)`` lay them
    out, so that K3 reads them in place.

    On the card the kernel reads whole 16-byte chunks of each pixel where
    ``x_q`` and its strides allow it (pixels at 16-byte multiples) and bytes
    otherwise. Each launch adds one to ``int8_dwconv_requant.launches``.
    """
    if x_q.dim() != 4 or w_packed.dim() != 2:
        raise ValueError(f"int8_dwconv_requant: x {tuple(x_q.shape)} is not "
                         f"NHWC or w {tuple(w_packed.shape)} not packed")
    b, h, w, c = x_q.shape
    if tuple(w_packed.shape) != (k * k, _pad16(c)):
        raise ValueError(f"int8_dwconv_requant: w {tuple(w_packed.shape)} "
                         f"is not pack_dw_weight of a {k}x{k} depthwise "
                         f"kernel over {c} channels")
    if x_q.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise TypeError("int8_dwconv_requant: x and w must be int8")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (c,) or t.dtype != torch.float32:
            raise ValueError(f"int8_dwconv_requant: {name} must be ({c},) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    if not (emit_q or emit_f):
        raise ValueError("int8_dwconv_requant: need emit_q or emit_f")
    if emit_f and f_dtype not in F_KINDS:
        raise TypeError(f"int8_dwconv_requant: f_dtype must be float32 or "
                        f"bfloat16, got {f_dtype}")
    if x_q.numel() < 1:
        raise ValueError(f"int8_dwconv_requant: empty input "
                         f"{tuple(x_q.shape)}")
    if emit_q:
        s_y = _as_scale(s_y, x_q.device)
    impl = _int8_dwconv_cuda if _build.eager(x_q) else int8_dwconv_requant_op
    return _emitted(*impl(x_q, w_packed, k, scale, bias, s_y, relu, emit_q,
                          emit_f, f_dtype), emit_q, emit_f)


def _int8_dwconv_cuda(x_q: torch.Tensor, w_packed: torch.Tensor, k: int,
                      scale: torch.Tensor, bias: torch.Tensor,
                      s_y: Optional[torch.Tensor], relu: bool, emit_q: bool,
                      emit_f: bool, f_dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: one launch of the kernel."""
    b, h, w, c = x_q.shape
    if k not in KERNEL_SIZES:
        raise NotImplementedError(f"int8_dwconv_requant: the kernel is built "
                                  f"for k in {KERNEL_SIZES}, got {k}")
    dev = x_q.device
    for t in (w_packed, scale, bias):
        if t.device != dev:
            raise ValueError("int8_dwconv_requant: all operands on one "
                             "device")
    if not (w_packed.is_contiguous() and _aligned(w_packed)):
        raise ValueError("int8_dwconv_requant: w must be pack_dw_weight's "
                         "contiguous, 16-byte aligned tensor")
    strides = x_q.stride()
    vec = (strides[3] == 1 and strides[2] >= c
           and _aligned(x_q, *strides[:3]))
    scale, bias = scale.contiguous(), bias.contiguous()
    q, f = _outputs(x_q, (b, h, w), c, emit_q, emit_f, f_dtype)
    sy_ptr = q_ptr = f_ptr = None
    f_vec = 0
    if emit_q:
        s_y = _as_scale(s_y, dev)
        sy_ptr, q_ptr = s_y.data_ptr(), q.data_ptr()
    if emit_f:
        f_ptr = f.data_ptr()
        f_vec = 16 // f.element_size()
        if c % f_vec:
            f_vec = 1
    with torch.cuda.device(dev):
        err = _lib().dw_launch(
            x_q.data_ptr(), *strides, int(vec), b, h, w, c, k,
            w_packed.data_ptr(), scale.data_ptr(), bias.data_ptr(), sy_ptr,
            q_ptr, _pad16(c), f_ptr, F_KINDS[f_dtype] if emit_f else 0,
            f_vec, int(relu), _build.stream(dev))
    if err != 0:
        raise RuntimeError(f"int8_dwconv_requant: kernel launch failed with "
                           f"cudaError_t {err}")
    int8_dwconv_requant.launches += 1
    return q, f


int8_dwconv_requant_op = torch.library.custom_op(
    "densereg::int8_dwconv_requant", _int8_dwconv_cuda, mutates_args=(),
    device_types="cuda")


@int8_dwconv_requant_op.register_kernel("cpu")
def _int8_dwconv_requant_cpu(x_q, w_packed, k, scale, bias, s_y, relu,
                             emit_q, emit_f, f_dtype):
    return _filled(*int8_dwconv_requant_reference(
        x_q, w_packed, k, scale, bias, s_y, relu=relu, emit_q=emit_q,
        emit_f=emit_f, f_dtype=f_dtype), x_q, f_dtype)


@int8_dwconv_requant_op.register_fake
def _int8_dwconv_requant_fake(x_q, w_packed, k, scale, bias, s_y, relu,
                              emit_q, emit_f, f_dtype):
    return _outputs(x_q, x_q.shape[:3], x_q.shape[3], emit_q, emit_f,
                    f_dtype)


int8_dwconv_requant.launches = 0
