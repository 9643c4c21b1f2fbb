"""A standalone int8 quantize step of the calibrated int8 forward, with the
sum of a residual or an hourglass folded in: ``csrc/int8_quantize.cu``.

:func:`int8_quantize` gives the scale ``s = max(amax, 1e-8) / 127``, the
sum ``f = a + b`` where an addend ``b`` is given, and ``q``, the int8
quantization of ``f`` (else of ``a``) with ``s``, its pixels 16 bytes apart
as K3 and the depthwise kernel read them. Its custom op (``ops._build.Op``)
is ``densereg::int8_quantize``; its plain form, :func:`act_scale`, the add
and ``ops.int8_layout.quantize`` (:func:`int8_quantize_reference`), is the
kernel's oracle.

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
from densereg_torch.ops.int8_layout import (
    F_KINDS,
    filled,
    outputs,
    pad16,
    quantize,
)

# the kernel's paths, in the order its launch function reports them: 16
# bytes a thread where C % 16 == 0 and the inputs start at 16-byte
# multiples, else one element a thread
PATHS = ("flat", "elements")

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 3


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


def _outputs(a: torch.Tensor, b: Optional[torch.Tensor], amax=None):
    """New ``(q, f, s)`` for ``a`` and the addend ``b``: ``(q, f)`` as
    ``int8_layout.outputs`` makes them (q with rows every ``ceil(C / 16) *
    16`` bytes, f like ``a`` where there is a sum), s 0-d float32. The
    kernel's wrapper allocates through here, and it is the op's fake."""
    q, f = outputs(a, a.shape[:-1], a.shape[-1], True, b is not None,
                   a.dtype, True)
    return q, f, a.new_empty((), dtype=torch.float32)


def _check(a: torch.Tensor, b: Optional[torch.Tensor],
           amax: torch.Tensor) -> None:
    if a.dtype not in F_KINDS:
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
    q, f, s = _OP.impl_for(a)(a, b, amax)
    return q, (None if b is None else f), s


def _int8_quantize_cuda(a: torch.Tensor, b: Optional[torch.Tensor],
                        amax: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The op's CUDA implementation: one launch of the kernel."""
    _check(a, b, amax)
    if not (a.is_contiguous() and (b is None or b.is_contiguous())):
        raise ValueError("int8_quantize: a and b must be contiguous on the "
                         "card")
    q, f, s = _outputs(a, b)
    c = a.shape[-1]
    _KERNEL(a.device, (a.data_ptr(), None if b is None else b.data_ptr(),
                       amax.data_ptr(), q.data_ptr(),
                       None if b is None else f.data_ptr(), s.data_ptr(),
                       a.numel(), c, pad16(c), F_KINDS[a.dtype]))
    return q, f, s


def _int8_quantize_cpu(a, b, amax):
    _check(a, b, amax)
    q, f, s = int8_quantize_reference(a, b, amax)
    q, f = filled(q, None if f is None else f.contiguous(), a, a.dtype)
    return q, f, s


_OP = _build.Op("int8_quantize", _int8_quantize_cuda, _int8_quantize_cpu,
                _outputs)
_KERNEL = _build.Kernel("int8_quantize", "quantize_launch", _ARGTYPES,
                        int8_quantize, paths=PATHS)
