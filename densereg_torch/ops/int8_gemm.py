"""int8 convolution / GEMM with the requantisation epilogue fused (K3):
``csrc/int8_gemm.cu``.

Replaces the TPU kernel ``densereg_tpu/ops/int8_gemm.py::int8_gemm_requant``.
Two entries launch the one kernel:

- :func:`int8_gemm_requant`, the dense entry: ``(M, K) @ (K, N)``, any M, N
  and K (a 1x1 stride-1 convolution reads its NHWC activation as the
  matrix);
- :func:`int8_conv_requant`, the implicit-GEMM entry: a k x k SAME
  convolution that reads the NHWC activation in place, with weights packed
  by :func:`pack_weight`.

Each entry is a ``torch.library`` custom op (``densereg::int8_gemm_requant``,
``densereg::int8_conv_requant``), so that an exported program holds it. On
CUDA tensors each launches the hand-written kernel (or raises); on CPU
tensors each runs its plain torch form (:func:`int8_gemm_requant_reference`,
:func:`int8_conv_requant_reference`), the kernel's oracle.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from densereg_torch.ops import _build

# |acc| <= 127 * 127 * K must fit in int32
MAX_K = (2 ** 31 - 1) // (127 * 127)
F_KINDS = {torch.float32: 1, torch.bfloat16: 2}
# depth of the kernel's shared-memory ring of K tiles
STAGES = 3

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_int] * 11
             + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                        ctypes.c_longlong]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_gemm")
    fn = lib.k3_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def same_pads(size: int, window: int, stride: int):
    """(before, after) padding of XLA's SAME for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def quantize(xf: torch.Tensor, s: torch.Tensor,
             pitch16: bool = False) -> torch.Tensor:
    """``clip(round(xf / s), -127, 127)`` as int8, with ``s`` a 0-d float32
    tensor on ``xf``'s device. Dividing by a tensor (not by a Python number,
    which PyTorch's CUDA kernels turn into a multiply by the reciprocal)
    keeps the division IEEE on the card, so the card and the CPU round to
    the same int8 step. ``pitch16`` returns a view whose rows (the last
    axis) start every ``ceil(C / 16) * 16`` bytes, as the kernel's ``q``;
    the bytes past C are left unwritten."""
    r = torch.clamp(torch.round(xf.float() / s), -127, 127)
    c = r.shape[-1]
    if not pitch16 or c % 16 == 0:
        return r.to(torch.int8)
    out = torch.empty(r.shape[:-1] + (_pad16(c),), dtype=torch.int8,
                      device=r.device)[..., :c]
    return out.copy_(r)


def im2col_nhwc(x: torch.Tensor, k: int, stride: int):
    """NHWC int8 ``x`` -> the ``(b * oh * ow, k * k * C)`` matrix of a
    k x k SAME convolution, K in (kh, kw, C) order (an HWIO kernel's), and
    ``(b, oh, ow)``. Built from k^2 strided slices of the zero-padded
    tensor: int8 0 is float 0, so the padding is exact. Rows start every
    16 bytes. A 1x1 stride-1 convolution reads ``x`` itself. The plain
    form of the kernel's implicit GEMM: each call on a CUDA tensor adds one
    to ``im2col_nhwc.cuda_calls``, which the serving path keeps at 0."""
    if x.is_cuda:
        im2col_nhwc.cuda_calls += 1
    b, h, w, c = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    if k == 1 and stride == 1:
        return x.reshape(b * h * w, c), (b, h, w)
    ph, pw = same_pads(h, k, stride), same_pads(w, k, stride)
    xp = x.new_zeros((b, h + sum(ph), w + sum(pw), c))
    xp[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w] = x
    kk = k * k * c
    cols = x.new_empty((b, oh, ow, _pad16(kk)))
    for i in range(k):
        for j in range(k):
            o = (i * k + j) * c
            cols[..., o:o + c] = xp[:, i:i + (oh - 1) * stride + 1:stride,
                                    j:j + (ow - 1) * stride + 1:stride]
    return cols.reshape(b * oh * ow, -1)[:, :kk], (b, oh, ow)


im2col_nhwc.cuda_calls = 0


def pack_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """HWIO int8 ``(k, k, C, N)`` -> the kernel's ``(N, k * k * Cp)`` int8
    operand, ``Cp = ceil(C / 16) * 16``, K in (kh, kw, channel) order with
    zeros at every padded channel of every tap. Those zeros are what make
    an activation's pitch bytes (never written, so anything) add exactly 0
    to the int32 sums. ``w[:, :C].t()`` of a 1x1 kernel's is the dense
    entry's ``(K, N)`` operand."""
    kh, kw, c, n = kernel_q.shape
    w = kernel_q.new_zeros((n, kh, kw, _pad16(c)))
    w[..., :c] = kernel_q.permute(3, 0, 1, 2)
    return w.reshape(n, -1)


def unpack_weight(w_packed: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """The ``(k * k * C, N)`` HWIO matrix of a :func:`pack_weight` operand
    (the im2col GEMM's w)."""
    n = w_packed.shape[0]
    return w_packed.reshape(n, k * k, -1)[:, :, :c].reshape(n, -1).t()


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
    return requant_reference(acc, scale, bias, s_y, relu=relu,
                             emit_q=emit_q, emit_f=emit_f, f_dtype=f_dtype)


def requant_reference(acc, scale, bias, s_y=None, *, relu: bool = True,
                      emit_q: bool = True, emit_f: bool = False,
                      f_dtype=torch.bfloat16):
    """The epilogue of the int8 kernels in plain torch, on exact integer
    sums ``acc`` (any integer or float64 dtype) with the channels last:
    ``y = relu?(float32(acc) * scale + bias)``, each operation rounded once,
    then ``(q, f)`` as :func:`int8_gemm_requant` returns them."""
    y = acc.float() * scale.float()
    y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    q = quantize(y, _as_scale(s_y, y.device)) if emit_q else None
    f = y.to(f_dtype) if emit_f else None
    return q, f


def int8_conv_requant_reference(x_q, w_packed, k: int, stride: int, scale,
                                bias, s_y=None, **kw):
    """Plain form of :func:`int8_conv_requant`: :func:`im2col_nhwc` and
    :func:`int8_gemm_requant_reference`, outputs ``(b, oh, ow, N)``."""
    cols, shape = im2col_nhwc(x_q, k, stride)
    w = unpack_weight(w_packed, k, x_q.shape[-1])
    return tuple(None if t is None else t.reshape(*shape, -1)
                 for t in int8_gemm_requant_reference(cols, w, scale, bias,
                                                      s_y, **kw))


def _as_scale(s_y, device) -> torch.Tensor:
    """``s_y`` as a 0-d float32 tensor on ``device``."""
    if s_y is None:
        raise ValueError("int8_gemm_requant: emit_q needs s_y")
    if not isinstance(s_y, torch.Tensor):
        return torch.full((), float(s_y), dtype=torch.float32, device=device)
    return s_y.reshape(()).to(device=device, dtype=torch.float32)


def _check(x_q, w_q, n, k, scale, bias, emit_q, emit_f, f_dtype):
    """What both entries require; ``k`` is the K the kernel runs over."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError("int8_gemm_requant: x and w must be int8")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"int8_gemm_requant: {name} must be ({n},) "
                             f"float32, got {tuple(t.shape)} {t.dtype}")
    for t in (w_q, scale, bias):
        if t.device != x_q.device:
            raise ValueError("int8_gemm_requant: all operands on one device")
    if not 1 <= k <= MAX_K or x_q.numel() < 1 or n < 1:
        raise ValueError(f"int8_gemm_requant: M, N >= 1 and 1 <= K <= "
                         f"{MAX_K}, got M x K = {tuple(x_q.shape)}, K={k}, "
                         f"N={n}")
    if not (emit_q or emit_f):
        raise ValueError("int8_gemm_requant: need emit_q or emit_f")
    if emit_f and f_dtype not in F_KINDS:
        raise TypeError(f"int8_gemm_requant: f_dtype must be float32 or "
                        f"bfloat16, got {f_dtype}")


def _aligned(t: torch.Tensor, *strides: int) -> bool:
    return t.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in strides)


def _outputs(ref: torch.Tensor, lead, n: int, emit_q: bool, emit_f: bool,
             f_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """New ``(q, f)`` of shape ``lead + (N,)`` on ``ref``'s device, as the
    kernel (CUDA) or the plain version (CPU) lays them out: on the card q's
    rows start every ``ceil(N / 16) * 16`` bytes. The one not asked for is
    an empty ``(0,)`` tensor: a custom op returns a fixed number of
    tensors. Both the implementations and the fake of each entry allocate
    through here, so that their layouts agree."""
    lead = tuple(lead)
    if not emit_q:
        q = ref.new_empty((0,), dtype=torch.int8)
    elif ref.is_cuda:
        q = ref.new_empty(lead + (_pad16(n),), dtype=torch.int8)[..., :n]
    else:
        q = ref.new_empty(lead + (n,), dtype=torch.int8)
    f = ref.new_empty(lead + (n,) if emit_f else (0,), dtype=f_dtype)
    return q, f


def _filled(q, f, ref, f_dtype):
    """A plain version's ``(q, f)`` with each None an empty ``(0,)``
    tensor, as the custom ops return them."""
    if q is None:
        q = ref.new_empty((0,), dtype=torch.int8)
    if f is None:
        f = ref.new_empty((0,), dtype=f_dtype)
    return q, f


def _launch(x, strides, geom, w, ldw, kw, n, scale, bias, s_y, relu,
            emit_q, emit_f, f_dtype):
    """Allocate the outputs and launch the kernel on ``x``'s device and
    current stream. ``geom = (b, h, w, oh, ow, cp, k, stride, ph, pw)``.
    Returns ``(q, f)`` as ``(b * oh * ow, N)`` views, q with a 16-byte row
    pitch (each an empty ``(0,)`` tensor where not asked for)."""
    b, _, _, oh, ow = geom[:5]
    dev = x.device
    scale = scale.contiguous()
    bias = bias.contiguous()
    q, f = _outputs(x, (b * oh * ow,), n, emit_q, emit_f, f_dtype)
    sy_ptr = q_ptr = f_ptr = None
    ldq = ldf = f_vec = 0
    if emit_q:
        s_y = _as_scale(s_y, dev)
        ldq = q.stride(0)
        sy_ptr, q_ptr = s_y.data_ptr(), q.data_ptr()
    if emit_f:
        f_ptr, ldf = f.data_ptr(), n
        f_vec = 16 // f.element_size()
        while f_vec > 1 and n % f_vec:
            f_vec //= 2
    with torch.cuda.device(dev):
        err = _lib().k3_launch(
            x.data_ptr(), *strides, *geom, n, w.data_ptr(), ldw, kw,
            scale.data_ptr(), bias.data_ptr(), sy_ptr, q_ptr, ldq, f_ptr,
            ldf, F_KINDS[f_dtype] if emit_f else 0, f_vec, int(relu),
            STAGES, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_gemm_requant: kernel launch failed with "
                           f"cudaError_t {err}")
    int8_gemm_requant.launches += 1
    return q, f


def _emitted(q, f, emit_q: bool, emit_f: bool):
    """A custom op's ``(q, f)`` as the entries return them: None for the
    one not asked for."""
    return (q if emit_q else None), (f if emit_f else None)


def int8_gemm_requant(x_q, w_q, scale, bias, s_y=None, *, relu: bool = True,
                      emit_q: bool = True, emit_f: bool = False,
                      f_dtype=torch.bfloat16):
    """``y = relu?((x_q @ w_q) * scale + bias)`` with int32 sums; returns
    ``(q, f)``: ``q = clip(round(y / s_y), -127, 127)`` int8 and ``f = y``
    in ``f_dtype`` (float32 or bfloat16), the one not asked for None.

    x_q (M, K) int8 and w_q (K, N) int8, any M, N, K; scale and bias (N,)
    float32 (``scale = s_x * s_w``); s_y a 0-d float32 tensor (or a number)
    on the same device. On the card x_q is read 16 bytes at a time: rows
    that do not start at 16-byte multiples are copied so first. w_q is read
    as its (N, K) transpose: pass a (K, N) view of a K-contiguous tensor
    whose rows start every 16 bytes (``pack_weight(...)[:, :K].t()``), else
    it is copied so. ``q`` comes back as an (M, N) view whose rows start
    every ``ceil(N / 16) * 16`` bytes, so that a following call reads them
    in place.

    The custom op ``densereg::int8_gemm_requant``: on CUDA tensors it
    launches the kernel (or raises), on CPU tensors it runs
    :func:`int8_gemm_requant_reference`. Each launch of the kernel (by
    either entry) adds one to ``int8_gemm_requant.launches``.
    """
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"int8_gemm_requant: x {tuple(x_q.shape)} and w "
                         f"{tuple(w_q.shape)} are not (M, K) and (K, N)")
    if emit_q:
        s_y = _as_scale(s_y, x_q.device)
    impl = _int8_gemm_cuda if _build.eager(x_q) else int8_gemm_requant_op
    return _emitted(*impl(x_q, w_q, scale, bias, s_y, relu, emit_q, emit_f,
                          f_dtype), emit_q, emit_f)


def _int8_gemm_cuda(x_q: torch.Tensor, w_q: torch.Tensor,
                    scale: torch.Tensor, bias: torch.Tensor,
                    s_y: Optional[torch.Tensor], relu: bool, emit_q: bool,
                    emit_f: bool, f_dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense entry's CUDA implementation: one launch of the kernel."""
    m, k = x_q.shape
    n = w_q.shape[1]
    kp = _pad16(k)
    _check(x_q, w_q, n, kp, scale, bias, emit_q, emit_f, f_dtype)
    if not (x_q.stride(1) == 1 and x_q.stride(0) >= kp
            and _aligned(x_q, x_q.stride(0))):
        x_q = torch.empty((m, kp), dtype=torch.int8,
                          device=x_q.device)[:, :k].copy_(x_q)
    if not (w_q.stride(0) == 1 and w_q.stride(1) >= kp
            and _aligned(w_q, w_q.stride(1))):
        # the kernel cuts w's rows at K, so the pitch bytes stay unwritten
        w_q = torch.empty((n, kp), dtype=torch.int8,
                          device=w_q.device)[:, :k].copy_(w_q.t()).t()
    # a matrix is an image of one row of M pixels, convolved 1x1
    return _launch(x_q, (0, 0, x_q.stride(0)),
                   (1, 1, m, 1, m, kp, 1, 1, 0, 0), w_q, w_q.stride(1), k, n,
                   scale, bias, s_y, relu, emit_q, emit_f, f_dtype)


int8_gemm_requant_op = torch.library.custom_op(
    "densereg::int8_gemm_requant", _int8_gemm_cuda, mutates_args=(),
    device_types="cuda")


@int8_gemm_requant_op.register_kernel("cpu")
def _int8_gemm_requant_cpu(x_q, w_q, scale, bias, s_y, relu, emit_q, emit_f,
                           f_dtype):
    return _filled(*int8_gemm_requant_reference(
        x_q, w_q, scale, bias, s_y, relu=relu, emit_q=emit_q, emit_f=emit_f,
        f_dtype=f_dtype), x_q, f_dtype)


@int8_gemm_requant_op.register_fake
def _int8_gemm_requant_fake(x_q, w_q, scale, bias, s_y, relu, emit_q, emit_f,
                            f_dtype):
    return _outputs(x_q, x_q.shape[:1], w_q.shape[1], emit_q, emit_f,
                    f_dtype)


def int8_conv_requant(x_q, w_packed, k: int, stride: int, scale, bias,
                      s_y=None, *, relu: bool = True, emit_q: bool = True,
                      emit_f: bool = False, f_dtype=torch.bfloat16):
    """The k x k SAME convolution (XLA's pads: uneven for stride 2) of the
    NHWC int8 ``x_q`` (b, h, w, C) with the :func:`pack_weight` operand
    ``w_packed`` (N, k * k * Cp), then the epilogue of
    :func:`int8_gemm_requant`; returns ``(q, f)`` as ``(b, oh, ow, N)``.

    On the card the kernel reads ``x_q`` in place, 16 bytes of a pixel at a
    time: every pixel must start at a multiple of 16 bytes (the layout of
    :func:`quantize` with ``pitch16`` and of the kernel's ``q``). Anything
    else raises: it is not copied quietly. Calls the custom op
    ``densereg::int8_conv_requant`` (CPU: :func:`int8_conv_requant_reference`).
    """
    if x_q.dim() != 4 or w_packed.dim() != 2:
        raise ValueError(f"int8_conv_requant: x {tuple(x_q.shape)} is not "
                         f"NHWC or w {tuple(w_packed.shape)} not packed")
    c = x_q.shape[3]
    kk = w_packed.shape[1]
    if kk != k * k * _pad16(c):
        raise ValueError(f"int8_conv_requant: w {tuple(w_packed.shape)} is "
                         f"not pack_weight of a {k}x{k}x{c} kernel")
    if emit_q:
        s_y = _as_scale(s_y, x_q.device)
    impl = _int8_conv_cuda if _build.eager(x_q) else int8_conv_requant_op
    return _emitted(*impl(x_q, w_packed, k, stride, scale, bias, s_y, relu,
                          emit_q, emit_f, f_dtype), emit_q, emit_f)


def _int8_conv_cuda(x_q: torch.Tensor, w_packed: torch.Tensor, k: int,
                    stride: int, scale: torch.Tensor, bias: torch.Tensor,
                    s_y: Optional[torch.Tensor], relu: bool, emit_q: bool,
                    emit_f: bool, f_dtype: torch.dtype
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The implicit-GEMM entry's CUDA implementation: one launch of the
    kernel."""
    b, h, w, c = x_q.shape
    n, kk = w_packed.shape
    _check(x_q, w_packed, n, kk, scale, bias, emit_q, emit_f, f_dtype)
    if (x_q.stride(3) != 1 or x_q.stride(2) < c
            or not _aligned(x_q, *x_q.stride()[:3])):
        raise ValueError(f"int8_conv_requant: pixels of x must start at "
                         f"16-byte multiples, got strides {x_q.stride()}")
    if w_packed.stride(1) != 1 or not _aligned(w_packed, w_packed.stride(0)):
        raise ValueError("int8_conv_requant: w rows must start at 16-byte "
                         "multiples (pack_weight's layout)")
    oh, ow = -(-h // stride), -(-w // stride)
    geom = (b, h, w, oh, ow, _pad16(c), k, stride,
            same_pads(h, k, stride)[0], same_pads(w, k, stride)[0])
    q, f = _launch(x_q, x_q.stride()[:3], geom, w_packed, w_packed.stride(0),
                   kk, n, scale, bias, s_y, relu, emit_q, emit_f, f_dtype)
    return tuple(t.reshape(b, oh, ow, n) if t.numel() else t
                 for t in (q, f))


int8_conv_requant_op = torch.library.custom_op(
    "densereg::int8_conv_requant", _int8_conv_cuda, mutates_args=(),
    device_types="cuda")


@int8_conv_requant_op.register_kernel("cpu")
def _int8_conv_requant_cpu(x_q, w_packed, k, stride, scale, bias, s_y, relu,
                           emit_q, emit_f, f_dtype):
    return _filled(*int8_conv_requant_reference(
        x_q, w_packed, k, stride, scale, bias, s_y, relu=relu, emit_q=emit_q,
        emit_f=emit_f, f_dtype=f_dtype), x_q, f_dtype)


@int8_conv_requant_op.register_fake
def _int8_conv_requant_fake(x_q, w_packed, k, stride, scale, bias, s_y, relu,
                            emit_q, emit_f, f_dtype):
    b, h, w, _ = x_q.shape
    return _outputs(x_q, (b, -(-h // stride), -(-w // stride)),
                    w_packed.shape[0], emit_q, emit_f, f_dtype)


int8_gemm_requant.launches = 0
