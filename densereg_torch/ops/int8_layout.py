"""The int8 layout and epilogue that K3 (``ops.int8_gemm``), the depthwise
kernel (``ops.int8_dwconv``), the quantize kernel (``ops.int8_quantize``)
and the int8 layers (``models.layers``) share: activations whose pixels
start every ``pad16(C)`` bytes, and the ``(q, f)`` a requantising kernel
returns.
"""

from __future__ import annotations

from typing import Tuple

import torch

# the float output's dtypes, as the kernels' C entries number them
F_KINDS = {torch.float32: 1, torch.bfloat16: 2}

_EMPTY = {}   # (device, dtype) -> a card's shared (0,) placeholder


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def aligned(t: torch.Tensor, *strides: int) -> bool:
    """Whether ``t`` starts at a 16-byte multiple and so do ``strides``."""
    return t.data_ptr() % 16 == 0 and all(s % 16 == 0 for s in strides)


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
    out = torch.empty(r.shape[:-1] + (pad16(c),), dtype=torch.int8,
                      device=r.device)[..., :c]
    return out.copy_(r)


def as_scale(s_y, device) -> torch.Tensor:
    """``s_y`` as a 0-d float32 tensor on ``device``."""
    if s_y is None:
        raise ValueError("int8_gemm_requant: emit_q needs s_y")
    if not isinstance(s_y, torch.Tensor):
        return torch.full((), float(s_y), dtype=torch.float32, device=device)
    return s_y.reshape(()).to(device=device, dtype=torch.float32)


def check_operands(who: str, x_q, w, n: int, scale, bias, emit_q: bool,
                   emit_f: bool, f_dtype) -> None:
    """What a requantising kernel requires of its operands: int8 ``x_q``
    and ``w``, ``(n,)`` float32 ``scale`` and ``bias``, an output asked for
    and ``f_dtype`` one of :data:`F_KINDS`; ``who`` names the kernel."""
    if x_q.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"{who}: x and w must be int8")
    for name, t in (("scale", scale), ("bias", bias)):
        if t.shape != (n,) or t.dtype != torch.float32:
            raise ValueError(f"{who}: {name} must be ({n},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if not (emit_q or emit_f):
        raise ValueError(f"{who}: need emit_q or emit_f")
    if emit_f and f_dtype not in F_KINDS:
        raise TypeError(f"{who}: f_dtype must be float32 or bfloat16, got "
                        f"{f_dtype}")


def empty(ref: torch.Tensor, dtype) -> torch.Tensor:
    """The ``(0,)`` tensor of ``dtype`` a custom op (a fixed number of
    outputs) returns for one not asked for. It holds no element, so the
    launches on a card share one; a CPU or a traced ``ref`` gets its own."""
    if not ref.is_cuda or type(ref) is not torch.Tensor:
        return ref.new_empty((0,), dtype=dtype)
    key = (ref.device, dtype)
    t = _EMPTY.get(key)
    if t is None:
        t = _EMPTY[key] = ref.new_empty((0,), dtype=dtype)
    return t


def outputs(ref: torch.Tensor, lead, n: int, emit_q: bool, emit_f: bool,
            f_dtype, pitch16: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """New ``(q, f)`` of shape ``lead + (N,)`` on ``ref``'s device: with
    ``pitch16`` (a kernel's layout) q's rows start every ``ceil(N / 16) *
    16`` bytes, else q is contiguous; the one not asked for is
    :func:`empty`. Each int8 kernel's implementation and its fake allocate
    through here, so that their layouts agree."""
    if not emit_q:
        q = empty(ref, torch.int8)
    elif pitch16 and n % 16:
        q = ref.new_empty(lead + (pad16(n),), dtype=torch.int8)[..., :n]
    else:
        q = ref.new_empty(lead + (n,), dtype=torch.int8)
    f = (ref.new_empty(lead + (n,), dtype=f_dtype) if emit_f
         else empty(ref, f_dtype))
    return q, f


def filled(q, f, ref: torch.Tensor, f_dtype):
    """A plain form's ``(q, f)`` with each None :func:`empty`, as the custom
    ops return them."""
    return (empty(ref, torch.int8) if q is None else q,
            empty(ref, f_dtype) if f is None else f)


def emitted(q, f, emit_q: bool, emit_f: bool):
    """A custom op's ``(q, f)`` as the wrappers return them: None for the
    one not asked for."""
    return (q if emit_q else None), (f if emit_f else None)


def requant_reference(acc, scale, bias, s_y=None, *, relu: bool = True,
                      emit_q: bool = True, emit_f: bool = False,
                      f_dtype=torch.bfloat16):
    """The epilogue of the int8 kernels in plain torch, on exact integer
    sums ``acc`` (any integer or float64 dtype) with the channels last:
    ``y = relu?(float32(acc) * scale + bias)``, each operation rounded once,
    then ``(q, f)`` as ``ops.int8_gemm.int8_gemm_requant`` returns them."""
    y = acc.float() * scale.float()
    y = y + bias.float()
    if relu:
        y = torch.clamp_min(y, 0.0)
    q = quantize(y, as_scale(s_y, y.device)) if emit_q else None
    f = y.to(f_dtype) if emit_f else None
    return q, f
