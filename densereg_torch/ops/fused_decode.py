"""Fused vote decode on CUDA: ``csrc/fused_decode.cu``.

Replaces the TPU kernel ``densereg_tpu/ops/fused_decode.py::fused_decode``.
The kernel is the ``torch.library`` custom op ``densereg::fused_decode``, so
that an exported program (``densereg_torch.export``) holds it: on a CUDA
tensor the op launches the hand-written kernel (or raises); on a CPU tensor
it runs :func:`fused_decode_reference`, the plain torch decode that is the
kernel's oracle.
"""

from __future__ import annotations

import ctypes

import torch

from densereg_torch import decode
from densereg_torch.config import EvalConfig
from densereg_torch.ops import _build

MAX_JOINTS = 32   # the grid's joint axis: ceil(J / 4) blocks of 4 warps
MAX_PICKS = 8     # the shared tail's 8-lane segment (kSeg in the source)
# the kernel's staging paths, by the layouts of hm and hm3: both read along
# pixel stride 1 (NHWC views of NCHW heads), hm or hm3 or both read along
# channel stride 1 (channels-last heads, J % 4 == 0), any other strides
PATHS = ("planes", "hm_pixels", "hm3_pixels", "pixels", "strided")

_ARGTYPES = ([ctypes.c_void_p] * 8
             + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_void_p])
_strides = {}               # stride tuples -> their ctypes array


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_decode")
    fn = lib.fused_decode_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def fused_decode_reference(hms, hm3s, ums, tiny_dms, cfgs, coms,
                           num_pt: int = 5, num_it: int = 10,
                           band_width: float = 0.4,
                           vote_grid: int = 4) -> torch.Tensor:
    """Plain torch form of the kernel: normalized poses ``(b, j, 3)``.

    The kernel is held to this form evaluated on the CPU: on CUDA tensors
    PyTorch's own kernels round some steps differently, which the mean
    shift can magnify to ~1e-5."""
    cfg = EvalConfig(num_candidates=num_pt, mean_shift_iters=num_it,
                     band_width=band_width, vote_grid=vote_grid)
    return decode.decode_plain(hms, hm3s, ums, tiny_dms, cfgs, coms, cfg)[0]


def _check(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt):
    b, h, w, j = hms.shape
    want = {"hms": (b, h, w, j), "hm3s": (b, h, w, j), "ums": (b, h, w, 3 * j),
            "tiny_dms": (b, h, w, 1), "cfgs": (b, 6), "coms": (b, 3)}
    args = {"hms": hms, "hm3s": hm3s, "ums": ums, "tiny_dms": tiny_dms,
            "cfgs": cfgs, "coms": coms}
    for name, t in args.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"fused_decode: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_decode: {name} must be float32, "
                            f"got {t.dtype}")
        if t.device != hms.device:
            raise ValueError(f"fused_decode: {name} is on {t.device}, "
                             f"hms on {hms.device}")
    if not 1 <= j <= MAX_JOINTS:
        raise ValueError(f"fused_decode: 1..{MAX_JOINTS} joints, got {j}")
    if not 1 <= num_pt <= min(MAX_PICKS, h * w):
        raise ValueError(f"fused_decode: num_pt must lie in "
                         f"[1, {min(MAX_PICKS, h * w)}], got {num_pt}")


def fused_decode(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt: int = 5,
                 num_it: int = 10, band_width: float = 0.4,
                 vote_grid: int = 4) -> torch.Tensor:
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
    impl = _fused_decode_cuda if _build.eager(hms) else fused_decode_op
    return impl(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt, num_it,
                band_width, vote_grid)


def _fused_decode_cuda(hms: torch.Tensor, hm3s: torch.Tensor,
                       ums: torch.Tensor, tiny_dms: torch.Tensor,
                       cfgs: torch.Tensor, coms: torch.Tensor, num_pt: int,
                       num_it: int, band_width: float,
                       vote_grid: int) -> torch.Tensor:
    """The op's CUDA implementation: one launch of the kernel."""
    b, h, w, j = hms.shape
    dev = hms.device
    f32 = torch.float32
    if not (hm3s.shape == hms.shape and ums.shape == (b, h, w, 3 * j)
            and tiny_dms.shape == (b, h, w, 1) and cfgs.shape == (b, 6)
            and coms.shape == (b, 3) and hms.dtype == f32
            and hm3s.dtype == f32 and ums.dtype == f32
            and tiny_dms.dtype == f32 and cfgs.dtype == f32
            and coms.dtype == f32 and hm3s.device == dev
            and ums.device == dev and tiny_dms.device == dev
            and cfgs.device == dev and coms.device == dev
            and 1 <= j <= MAX_JOINTS and 1 <= num_pt <= MAX_PICKS
            and num_pt <= h * w):
        _check(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt)
    out = torch.empty((b, j, 3), dtype=f32, device=dev)
    if b == 0:
        return out
    cfgs = cfgs.contiguous()
    coms = coms.contiguous()
    key = (hms.stride(), hm3s.stride(), ums.stride(), tiny_dms.stride())
    strides = _strides.get(key)
    if strides is None:
        strides = _strides[key] = (ctypes.c_longlong * 16)(
            *(s for t in key for s in t))
    args = (hms.data_ptr(), hm3s.data_ptr(), ums.data_ptr(),
            tiny_dms.data_ptr(), strides, cfgs.data_ptr(), coms.data_ptr(),
            out.data_ptr(), b, h, w, j, num_pt, num_it,
            -1.0 / (2.0 * band_width * band_width), vote_grid,
            float(vote_grid) - 0.1)
    launch = _lib().fused_decode_launch
    if dev.index == torch.cuda.current_device():
        path = launch(*args, _build.stream(dev))
    else:
        with torch.cuda.device(dev):
            path = launch(*args, _build.stream(dev))
    if path < 0:
        raise RuntimeError(f"fused_decode: kernel launch failed with "
                           f"cudaError_t {-path}")
    fused_decode.launches += 1
    fused_decode.launches_by_path[PATHS[path]] += 1
    return out


fused_decode_op = torch.library.custom_op(
    "densereg::fused_decode", _fused_decode_cuda, mutates_args=(),
    device_types="cuda")


@fused_decode_op.register_kernel("cpu")
def _fused_decode_cpu(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt, num_it,
                      band_width, vote_grid):
    return fused_decode_reference(hms, hm3s, ums, tiny_dms, cfgs, coms,
                                  num_pt, num_it, band_width, vote_grid)


@fused_decode_op.register_fake
def _fused_decode_fake(hms, hm3s, ums, tiny_dms, cfgs, coms, num_pt, num_it,
                       band_width, vote_grid):
    b, _, _, j = hms.shape
    return hms.new_empty((b, j, 3), dtype=torch.float32)


fused_decode.launches = 0
fused_decode.launches_by_path = dict.fromkeys(PATHS, 0)
