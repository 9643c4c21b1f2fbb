"""A standalone int8 quantize step of the calibrated int8 forward, with the
sum of a residual or an hourglass folded in: ``csrc/int8_quantize.cu``.

:func:`int8_quantize` gives the scale ``s = max(amax, 1e-8) / 127``, the
sum ``f = a + b`` where an addend ``b`` is given, and ``q``, the int8
quantization of ``f`` (else of ``a``) with ``s``, its pixels 16 bytes apart
as K3 and the depthwise kernel read them. It calls the custom op
``densereg::int8_quantize``: on CUDA tensors one launch of the hand-written
kernel (or it raises), on CPU tensors the plain form,
:func:`int8_quantize_reference`, which is :func:`act_scale`, the add and
``ops.int8_gemm.quantize``, the kernel's oracle.

The kernel replaces no TPU kernel: the JAX package leaves this glue to XLA,
which fuses it. It is bound by bytes, and reads each input and writes each
output once (16 bytes a thread where C % 16 == 0, else one element a
thread); PyTorch's eager form took 7 launches (8 with the sum), each a pass
over the whole tensor. It picks its path from what it is given (the dtype,
whether C % 16 == 0, the inputs' alignment, the addend): there is no
option.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from densereg_torch.ops import _build
from densereg_torch.ops.int8_gemm import _pad16, quantize

KINDS = {torch.float32: 1, torch.bfloat16: 2}

# the kernel's paths, in the order its launch function reports them: 16
# bytes a thread where C % 16 == 0 and the inputs start at 16-byte
# multiples, else one element a thread
PATHS = ("flat", "elements")

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong]
             + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int),
                                     ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("int8_quantize")
    fn = lib.quantize_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127``, a 0-d float32 tensor on ``amax``'s device,
    by an IEEE division (a CUDA division by a Python number goes through
    the reciprocal)."""
    amax = torch.clamp_min(amax.float(), 1e-8)
    return amax / amax.new_full((), 127.0)


def int8_quantize_reference(a: torch.Tensor, b: Optional[torch.Tensor],
                            amax: torch.Tensor):
    """Plain form of :func:`int8_quantize`: ``(q, f, s)``, f None without
    ``b``."""
    s = act_scale(amax)
    v = a if b is None else a + b
    return quantize(v, s, pitch16=True), (None if b is None else v), s


def _outputs(a: torch.Tensor, with_f: bool, f_placeholder: bool = True):
    """New ``(q, f, s)`` for ``a``: q with rows every ``ceil(C / 16) * 16``
    bytes, f like ``a`` (without the sum an empty ``(0,)`` tensor, as a
    custom op returns a fixed number of tensors, or None where
    ``f_placeholder`` is false), s 0-d float32. The kernel's wrapper and
    the fake allocate through here."""
    c = a.shape[-1]
    if c % 16 == 0:
        q = a.new_empty(a.shape, dtype=torch.int8)
    else:
        q = a.new_empty(a.shape[:-1] + (_pad16(c),),
                        dtype=torch.int8)[..., :c]
    if with_f:
        f = a.new_empty(a.shape)
    else:
        f = a.new_empty((0,)) if f_placeholder else None
    return q, f, a.new_empty((), dtype=torch.float32)


def _check(a: torch.Tensor, b: Optional[torch.Tensor],
           amax: torch.Tensor) -> None:
    if a.dtype not in KINDS:
        raise TypeError(f"int8_quantize: a must be float32 or bfloat16, got "
                        f"{a.dtype}")
    if a.dim() < 1 or a.numel() < 1:
        raise ValueError(f"int8_quantize: a must hold a channel axis and "
                         f"elements, got {tuple(a.shape)}")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype
                          or b.device != a.device):
        raise ValueError(f"int8_quantize: b {tuple(b.shape)} {b.dtype} "
                         f"{b.device} is not like a {tuple(a.shape)} "
                         f"{a.dtype} {a.device}")
    if (amax.dtype != torch.float32 or amax.dim() != 0
            or amax.device != a.device):
        raise ValueError(f"int8_quantize: amax must be a 0-d float32 on "
                         f"{a.device}, got {tuple(amax.shape)} {amax.dtype} "
                         f"{amax.device}")


def int8_quantize(a: torch.Tensor, amax: torch.Tensor,
                  b: Optional[torch.Tensor] = None):
    """``(q, f, s)``: ``s = max(amax, 1e-8) / 127`` (0-d float32), ``f = a
    + b`` in a's dtype (None without ``b``), ``q = clip(round(v / s), -127,
    127)`` int8 with ``v`` f, else ``a``, by an IEEE division, as an
    ``a``-shaped view whose rows start every ``ceil(C / 16) * 16`` bytes.

    ``a`` and ``b``: float32 or bfloat16 of one shape, channels last;
    ``amax``: a 0-d float32 on their device. On the card they must be
    contiguous. Each launch of the kernel adds one to
    ``int8_quantize.launches`` and to its path's count in
    ``int8_quantize.launches_by_path`` (:data:`PATHS`)."""
    if _build.eager(a):
        return _launch(a, b, amax, f_placeholder=False)
    q, f, s = int8_quantize_op(a, b, amax)
    return q, (None if b is None else f), s


def _launch(a: torch.Tensor, b: Optional[torch.Tensor], amax: torch.Tensor,
            f_placeholder: bool = True):
    """One launch of the kernel: ``(q, f, s)``, f as :func:`_outputs`
    makes it."""
    _check(a, b, amax)
    if not (a.is_contiguous() and (b is None or b.is_contiguous())):
        raise ValueError("int8_quantize: a and b must be contiguous on the "
                         "card")
    q, f, s = _outputs(a, b is not None, f_placeholder)
    c = a.shape[-1]
    dev = a.device
    path = ctypes.c_int(-1)
    args = (a.data_ptr(), None if b is None else b.data_ptr(),
            amax.data_ptr(), q.data_ptr(),
            None if b is None else f.data_ptr(), s.data_ptr(), a.numel(), c,
            _pad16(c), KINDS[a.dtype], ctypes.byref(path),
            _build.stream(dev))
    if dev.index == torch.cuda.current_device():
        err = _lib().quantize_launch(*args)
    else:
        with torch.cuda.device(dev):
            err = _lib().quantize_launch(*args)
    if err != 0:
        raise RuntimeError(f"int8_quantize: kernel launch failed with "
                           f"cudaError_t {err}")
    int8_quantize.launches += 1
    int8_quantize.launches_by_path[PATHS[path.value]] += 1
    return q, f, s


def _int8_quantize_cuda(a: torch.Tensor, b: Optional[torch.Tensor],
                        amax: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: one launch of the kernel."""
    return _launch(a, b, amax)


int8_quantize_op = torch.library.custom_op(
    "densereg::int8_quantize", _int8_quantize_cuda, mutates_args=(),
    device_types="cuda")


@int8_quantize_op.register_kernel("cpu")
def _int8_quantize_cpu(a, b, amax):
    _check(a, b, amax)
    q, f, s = int8_quantize_reference(a, b, amax)
    return q, (a.new_empty((0,)) if f is None else f.contiguous()), s


@int8_quantize_op.register_fake
def _int8_quantize_fake(a, b, amax):
    return _outputs(a, b is not None)


int8_quantize.launches = 0
int8_quantize.launches_by_path = dict.fromkeys(PATHS, 0)
