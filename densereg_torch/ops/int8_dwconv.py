"""Depthwise int8 convolution with the requantisation epilogue fused:
``csrc/int8_dwconv.cu``.

The port's own kernel, in K3's family. It has no Pallas counterpart: the
JAX package runs the depthwise convolutions of the ``um_v1_lite`` int8 net
as XLA's grouped int8 convolution (``densereg_tpu/models/layers.py:237-244``,
``feature_group_count`` = C), which torch lacks on CUDA, and K3 takes no
groups. Its custom op (``ops._build.Op``) is
``densereg::int8_dwconv_requant``.

The kernel is bound by bytes: at the card's byte rate an output may take
about 18 instruction issues before the instructions, not the bytes, set
its time. So it sums four taps of a channel with one ``dp4a`` (the staged
tile transposed to words of 4 adjacent pixels of one channel), stages its
tiles with the tensor memory accelerator (no instructions a byte, the SAME
padding as the copy's zero fill), requantises by a reciprocal with the
division kept for the few outputs near a tie (``csrc/requant.cuh``), and is
templated on the window and the tile, which :func:`plan_launch` picks here,
on the host, from the call's shape.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch

from densereg_torch.ops import _build
from densereg_torch.ops.int8_layout import (
    F_KINDS,
    aligned,
    as_scale,
    check_operands,
    emitted,
    filled,
    outputs,
    pad16,
    requant_reference,
    same_pads,
)

# window sizes the kernel is built for (a template instance each)
KERNEL_SIZES = (1, 3, 5)
# the tiles (output rows x columns) the kernel is built for, largest first:
# a thread computes 2 rows x 4 columns x 4 channels of one
TILES = ((8, 32), (8, 16), (8, 8), (4, 4), (2, 4))
MAX_THREADS = 256       # the kernel's __launch_bounds__
MAX_SMEM = 96 * 1024    # a plan's shared memory a block, at most: two
                        # such blocks fit an SM
STAGES = 3              # tiles a block stages at once (the kernel's kStages)
SMS = 132               # streaming multiprocessors of an H100 SXM

_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p]
             + [ctypes.c_int] * 11)


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One launch of the kernel: a tile is ``th x tw`` output pixels of
    ``cb`` channels (a power-of-two count of 16-channel chunks) of ``ipb``
    images; the tiles are ``(tiles_x * tiles_y, groups, image_groups)``
    (``blocks`` of them), and the kernel's persistent blocks walk the image
    groups of each (tile, channel group). ``threads`` and ``smem`` (bytes)
    are a block's: the C entry launches with them, and refuses a plan
    whose block is smaller than the kernel's layout (its ``smem_bytes``)."""

    th: int
    tw: int
    cb: int
    ipb: int
    tiles_x: int
    tiles_y: int
    groups: int
    image_groups: int
    threads: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.tiles_x * self.tiles_y * self.groups * self.image_groups

    @property
    def cb_log(self) -> int:
        """log2(cb / 16), as the C entry takes cb."""
        return (self.cb // 16).bit_length() - 1

    @property
    def ipb_log(self) -> int:
        return self.ipb.bit_length() - 1

    def origin(self, bx: int, by: int, bz: int):
        """(first image, first output row, first output column, first
        16-channel chunk) of tile ``(bx, by, bz)``, as the kernel decodes
        its block and image-group indices."""
        return (bz * self.ipb, bx // self.tiles_x * self.th,
                bx % self.tiles_x * self.tw, by * self.cb // 16)


def _smem(th: int, tw: int, cb: int, ipb: int, k: int) -> int:
    """Bytes of a block's shared memory, as the kernel lays them out
    (``csrc/int8_dwconv.cu::smem_bytes``, which checks each launch): a
    ring of :data:`STAGES` staged tiles as NHWC bytes (``[ipb][th + k -
    1][tw + 4 or tw pixels][cb]``, 128-byte aligned), the tile transposed
    to words of 4 pixels of a channel (``[ipb][th + k - 1][words][cb +
    4]``), the taps (a word a window row, two for k = 5), ``cb`` scales and
    biases, and a barrier a ring slot."""
    groups = (th + k - 1) * (tw // 4 + (k > 1)) * ipb
    tile = -(-groups * 4 * cb // 128) * 128
    return (128 + STAGES * tile + 4 * groups * (cb + 4)
            + 4 * (k * (2 if k == 5 else 1) * cb + 2 * cb) + 8 * STAGES)


@functools.lru_cache(maxsize=None)
def plan_launch(b: int, h: int, w: int, c: int, k: int) -> DwPlan:
    """The kernel's launch for a ``(b, h, w, c)`` activation and a ``k x
    k`` window: the largest tile of :data:`TILES` that the map fills, then
    the most channels and images a tile (at most :data:`MAX_THREADS`
    threads and :data:`MAX_SMEM` bytes a block), the first such plan with
    a tile for each SM, or for each 64 (image, pixel, 16-channel chunk)
    items where the call has fewer than ``64 * SMS``; where none has, the
    one with the most tiles. Cached: a wrapper call pays a lookup."""
    nchunks = pad16(c) // 16
    want = min(SMS, max(1, b * h * w * nchunks // 64))
    fits = [t for t in TILES
            if t[0] <= max(h, 2) and t[1] <= max(-(-w // 4) * 4, 4)]
    best = None
    for th, tw in fits:
        for cb in (64, 32, 16):
            if nchunks % (cb // 16):
                continue
            per_image = th // 2 * (tw // 4) * (cb // 4)
            ipb = 1
            while 2 * ipb * per_image <= MAX_THREADS and 2 * ipb <= b:
                ipb *= 2
            while ipb >= 1:
                plan = DwPlan(th, tw, cb, ipb, -(-w // tw), -(-h // th),
                              nchunks * 16 // cb, -(-b // ipb),
                              ipb * per_image, _smem(th, tw, cb, ipb, k))
                ipb //= 2
                if plan.threads > MAX_THREADS or plan.smem > MAX_SMEM:
                    continue
                if plan.blocks >= want:
                    return plan
                if best is None or plan.blocks > best.blocks:
                    best = plan
    return best


def pack_dw_weight(kernel_q: torch.Tensor) -> torch.Tensor:
    """A depthwise HWIO int8 kernel ``(k, k, 1, C)`` -> the kernel's
    ``(k * k, Cp)`` operand, ``Cp = ceil(C / 16) * 16``, taps in (kh, kw)
    order, zeros at the padded channels: what an activation's pitch bytes
    meet, so they add exactly 0."""
    kh, kw, one, c = kernel_q.shape
    if kh != kw or one != 1:
        raise ValueError(f"pack_dw_weight: {tuple(kernel_q.shape)} is not a "
                         f"depthwise (k, k, 1, C) kernel")
    w = kernel_q.new_zeros((kh * kw, pad16(c)))
    w[:, :c] = kernel_q.reshape(kh * kw, c)
    return w


def _taps(w_packed: torch.Tensor, k: int, c: int) -> torch.Tensor:
    """The ``(k, k, C)`` taps of a :func:`pack_dw_weight` operand."""
    return w_packed[:, :c].reshape(k, k, c)


def int8_dwconv_requant_reference(x_q, w_packed, k: int, scale, bias,
                                  s_y=None, **kw):
    """Plain form of :func:`int8_dwconv_requant`: the int32 sum over the
    k x k shifted slices of the zero-padded input, then
    ``int8_layout.requant_reference``."""
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
    bytes apart, as K3 and ``int8_layout.quantize(pitch16=True)`` lay them
    out, so that K3 reads them in place.

    On the card the kernel copies whole 16-byte chunks of each pixel with
    the tensor memory accelerator where ``x_q`` and its strides allow it
    (pixels at 16-byte multiples) and reads bytes otherwise. Each launch
    adds one to ``int8_dwconv_requant.launches``.
    """
    if x_q.dim() != 4 or w_packed.dim() != 2:
        raise ValueError(f"int8_dwconv_requant: x {tuple(x_q.shape)} is not "
                         f"NHWC or w {tuple(w_packed.shape)} not packed")
    b, h, w, c = x_q.shape
    if tuple(w_packed.shape) != (k * k, pad16(c)):
        raise ValueError(f"int8_dwconv_requant: w {tuple(w_packed.shape)} "
                         f"is not pack_dw_weight of a {k}x{k} depthwise "
                         f"kernel over {c} channels")
    check_operands("int8_dwconv_requant", x_q, w_packed, c, scale, bias,
                   emit_q, emit_f, f_dtype)
    if x_q.numel() < 1:
        raise ValueError(f"int8_dwconv_requant: empty input "
                         f"{tuple(x_q.shape)}")
    if emit_q:
        s_y = as_scale(s_y, x_q.device)
    return emitted(*_OP.impl_for(x_q)(x_q, w_packed, k, scale, bias, s_y,
                                      relu, emit_q, emit_f, f_dtype),
                   emit_q, emit_f)


def tensor_map_path(x_q: torch.Tensor) -> bool:
    """Whether the kernel stages ``x_q`` with the tensor memory
    accelerator (whole 16-byte chunks of each pixel: channels adjacent,
    pixels and the pointer at 16-byte multiples) or, where not, a byte at
    a time."""
    strides = x_q.stride()
    return (strides[3] == 1 and strides[2] >= x_q.shape[3]
            and aligned(x_q, *strides[:3]))


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
    if not (w_packed.is_contiguous() and aligned(w_packed)):
        raise ValueError("int8_dwconv_requant: w must be pack_dw_weight's "
                         "contiguous, 16-byte aligned tensor")
    strides = x_q.stride()
    scale, bias = scale.contiguous(), bias.contiguous()
    q, f = outputs(x_q, (b, h, w), c, emit_q, emit_f, f_dtype, True)
    sy_ptr = q_ptr = f_ptr = None
    f_vec = 0
    if emit_q:   # s_y: int8_dwconv_requant's 0-d float32 tensor on dev
        sy_ptr, q_ptr = s_y.data_ptr(), q.data_ptr()
    if emit_f:
        f_ptr = f.data_ptr()
        f_vec = 4 if c % 4 == 0 else 1
    plan = plan_launch(b, h, w, c, k)
    _KERNEL(dev, (x_q.data_ptr(), *strides, int(tensor_map_path(x_q)), b,
                  h, w, c, k, w_packed.data_ptr(), scale.data_ptr(),
                  bias.data_ptr(), sy_ptr, q_ptr, pad16(c), f_ptr,
                  F_KINDS[f_dtype] if emit_f else 0, f_vec, int(relu),
                  plan.th, plan.tw, plan.cb_log, plan.ipb_log, plan.tiles_x,
                  plan.tiles_y, plan.threads, plan.smem))
    return q, f


def _int8_dwconv_requant_cpu(x_q, w_packed, k, scale, bias, s_y, relu,
                             emit_q, emit_f, f_dtype):
    return filled(*int8_dwconv_requant_reference(
        x_q, w_packed, k, scale, bias, s_y, relu=relu, emit_q=emit_q,
        emit_f=emit_f, f_dtype=f_dtype), x_q, f_dtype)


def _int8_dwconv_requant_fake(x_q, w_packed, k, scale, bias, s_y, relu,
                              emit_q, emit_f, f_dtype):
    return outputs(x_q, x_q.shape[:3], x_q.shape[3], emit_q, emit_f,
                   f_dtype, x_q.is_cuda)


_OP = _build.Op("int8_dwconv_requant", _int8_dwconv_cuda,
                _int8_dwconv_requant_cpu, _int8_dwconv_requant_fake)
_KERNEL = _build.Kernel(
    "int8_dwconv", "dw_launch", _ARGTYPES, int8_dwconv_requant,
    notes={801: " (the driver refused x's tensor map)"})  # NotSupported
