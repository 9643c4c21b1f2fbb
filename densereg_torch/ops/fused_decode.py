"""Fused vote decode on CUDA: ``csrc/fused_decode.cu``.

Replaces the TPU kernel ``densereg_tpu/ops/fused_decode.py::fused_decode``.
Its custom op (``ops._build.Op``) is ``densereg::fused_decode``; its plain
form, :func:`fused_decode_reference`, is the kernel's oracle.
"""

from __future__ import annotations

import ctypes

import torch

from densereg_torch import decode
from densereg_torch.config import EvalConfig
from densereg_torch.ops import _build

MAX_JOINTS = 32   # the grid's joint axis: ceil(J / 4) blocks of 4 warps
MAX_PICKS = 8     # the shared tail's 8-lane segment (kSeg in the source)
# the mean shift's start: the vote grid's cells per axis, and all its cells
GRID = 4
NUM_CELLS = GRID ** 3
# the kernel's staging paths, by the layouts of hm and hm3: both read along
# pixel stride 1 (NHWC views of NCHW heads), hm or hm3 or both read along
# channel stride 1 (channels-last heads, J % 4 == 0), any other strides
PATHS = ("planes", "hm_pixels", "hm3_pixels", "pixels", "strided")

_ARGTYPES = ([ctypes.c_void_p] * 8
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_float])
_strides = {}               # stride tuples -> their ctypes array


def fused_decode_reference(hms, hm3s, ums, tiny_dms, cfgs, coms,
                           num_pt: int = 5, num_it: int = 10,
                           band_width: float = 0.4,
                           vote_grid: int = GRID) -> torch.Tensor:
    """Plain torch form of the kernel: normalized poses ``(b, j, 3)``.

    The kernel is held to this form evaluated on the CPU: on CUDA tensors
    PyTorch's own kernels round some steps differently, which the mean
    shift can magnify to ~1e-5."""
    cfg = EvalConfig(num_candidates=num_pt, mean_shift_iters=num_it,
                     band_width=band_width, vote_grid=vote_grid)
    return decode.decode_plain(hms, hm3s, ums, tiny_dms, cfgs, coms, cfg)[0]


def fused_decode(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt: int = 5,
                 num_it: int = 10, band_width: float = 0.4,
                 vote_grid: int = GRID) -> torch.Tensor:
    """hms/hm3s (b, h, w, j); ums (b, h, w, 3j); tiny_dms (b, h, w, 1);
    cfgs (b, 6); coms (b, 3), all float32 with any strides -> normalized
    poses (b, j, 3).

    The custom op ``densereg::fused_decode``: on CUDA tensors it launches
    the kernel (or raises), on CPU tensors it runs
    :func:`fused_decode_reference`; ``torch.export`` records the op itself.
    Each launch of the kernel adds one to ``fused_decode.launches`` and to
    ``fused_decode.launches_by_path[path]``, ``path`` one of
    :data:`PATHS`.
    """
    return _OP.impl_for(hms)(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt,
                             num_it, band_width, vote_grid)


def _fused_decode_cuda(hms: torch.Tensor, hm3s: torch.Tensor,
                       ums: torch.Tensor, tiny_dms: torch.Tensor,
                       cfgs: torch.Tensor, coms: torch.Tensor, num_pt: int,
                       num_it: int, band_width: float,
                       vote_grid: int) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the kernel."""
    b, h, w, j = hms.shape
    args = (hms, hm3s, ums, tiny_dms, cfgs, coms)
    want = ((b, h, w, j), (b, h, w, 3 * j), (b, h, w, 1), (b, 6), (b, 3))
    if (hm3s.shape, ums.shape, tiny_dms.shape, cfgs.shape,
            coms.shape) != want:
        raise ValueError(f"fused_decode: hm3s, ums, tiny_dms, cfgs, coms "
                         f"have shapes {[tuple(t.shape) for t in args[1:]]}"
                         f", expected {list(want)} for hms {tuple(hms.shape)}")
    if not (hms.dtype == hm3s.dtype == ums.dtype == tiny_dms.dtype
            == cfgs.dtype == coms.dtype == torch.float32):
        raise TypeError(f"fused_decode: every input must be float32, got "
                        f"{[t.dtype for t in args]}")
    dev = hms.device
    if not (dev == hm3s.device == ums.device == tiny_dms.device
            == cfgs.device == coms.device):
        raise ValueError(f"fused_decode: inputs on "
                         f"{[str(t.device) for t in args]}, not one device")
    if not 1 <= j <= MAX_JOINTS:
        raise ValueError(f"fused_decode: 1..{MAX_JOINTS} joints, got {j}")
    if not 1 <= num_pt <= min(MAX_PICKS, h * w):
        raise ValueError(f"fused_decode: num_pt must lie in "
                         f"[1, {min(MAX_PICKS, h * w)}], got {num_pt}")
    out = hms.new_empty((b, j, 3))
    if b == 0:
        return out
    cfgs = cfgs.contiguous()
    coms = coms.contiguous()
    key = (hms.stride(), hm3s.stride(), ums.stride(), tiny_dms.stride())
    strides = _strides.get(key)
    if strides is None:
        strides = _strides[key] = (ctypes.c_longlong * 16)(
            *(s for t in key for s in t))
    _KERNEL(dev, (hms.data_ptr(), hm3s.data_ptr(), ums.data_ptr(),
                  tiny_dms.data_ptr(), strides, cfgs.data_ptr(),
                  coms.data_ptr(), out.data_ptr(), b, h, w, j, num_pt,
                  num_it, -1.0 / (2.0 * band_width * band_width), vote_grid,
                  float(vote_grid) - 0.1))
    return out


def _fused_decode_fake(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt, num_it,
                       band_width, vote_grid):
    b, _, _, j = hms.shape
    return hms.new_empty((b, j, 3), dtype=torch.float32)


_OP = _build.Op("fused_decode", _fused_decode_cuda, fused_decode_reference,
                _fused_decode_fake)
_KERNEL = _build.Kernel("fused_decode", "fused_decode_launch", _ARGTYPES,
                        fused_decode, paths=PATHS)
