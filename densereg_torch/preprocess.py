"""Batched device-side preprocessing: crop (from stored boxes, or around
the pose with the joint-depth background cull), center of mass, depth
normalization, and the head-grid subsample.

Mirrors ``densereg_tpu/preprocess.py``, with an explicit batch dimension in
place of ``vmap``. The crop -> pad-to-square -> legacy-bilinear-resize chain
of the reference is one masked bilinear gather with a static output shape.
Frames may be float32 or uint16 depth in mm; they are cast to float32 on the
device they lie on.
"""

from __future__ import annotations

from typing import Optional

import torch

from densereg_torch import geometry
from densereg_torch.config import D_RANGE


def area_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Integer-ratio AREA (box-mean) shrink of ``(..., h, w, c)``, TF's
    ``ResizeMethod.AREA``: not what the reference's ``method=2`` resizes
    do (:func:`method2_resize`); the antialiased option."""
    h, w = x.shape[-3], x.shape[-2]
    if h % out_h or w % out_w:
        raise ValueError(
            f"area_resize needs integer ratio, got {h}x{w} -> {out_h}x{out_w}")
    lead, c = x.shape[:-3], x.shape[-1]
    x = x.reshape(lead + (out_h, h // out_h, out_w, w // out_w, c))
    return x.mean(dim=(-4, -2))


def _legacy_src(n_in: int, n_out: int, device) -> torch.Tensor:
    """TF1's legacy source coordinate of each output index,
    ``dst * (n_in / n_out)`` in float32."""
    scale = torch.tensor(n_in / n_out, dtype=torch.float32, device=device)
    return torch.arange(n_out, dtype=torch.float32, device=device) * scale


def resize_bilinear(img: torch.Tensor, out_h: int,
                    out_w: int) -> torch.Tensor:
    """TF1 legacy bilinear resize of ``(..., h, w, c)``
    (``align_corners=False``): source coordinate ``dst * (in / out)`` with
    edge clamping, not half-pixel centers; interpolated in float32 and
    returned in ``img``'s dtype."""
    h, w = img.shape[-3], img.shape[-2]

    def axis(n_in, n_out):
        src = _legacy_src(n_in, n_out, img.device)
        i0 = torch.floor(src).to(torch.int64).clamp(0, n_in - 1)
        i1 = torch.clamp_max(i0 + 1, n_in - 1)
        return i0, i1, src - i0.to(torch.float32)

    y0, y1, fy = axis(h, out_h)
    x0, x1, fx = axis(w, out_w)
    top = img.index_select(-3, y0)
    bot = img.index_select(-3, y1)
    tl, tr = (top.index_select(-2, i).to(torch.float32) for i in (x0, x1))
    bl, br = (bot.index_select(-2, i).to(torch.float32) for i in (x0, x1))
    fx = fx[:, None]
    t = tl + (tr - tl) * fx
    b = bl + (br - bl) * fx
    out = t + (b - t) * fy[:, None, None]
    return out.to(img.dtype)


def resize_nearest(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """TF1 legacy nearest resize of ``(..., h, w, c)``
    (``align_corners=False``): index ``floor(dst * in / out)``."""
    h, w = img.shape[-3], img.shape[-2]
    ys = _legacy_src(h, out_h, img.device).to(torch.int64).clamp(0, h - 1)
    xs = _legacy_src(w, out_w, img.device).to(torch.int64).clamp(0, w - 1)
    return img.index_select(-3, ys).index_select(-2, xs)


def method2_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """The reference's ``resize_images(x, s, 2)`` shrink on ``(..., h, w, c)``:
    for an integer ratio it is an exact ``[::r, ::r]`` subsample."""
    h, w = x.shape[-3], x.shape[-2]
    if h % out_h or w % out_w:
        raise ValueError(
            f"method2_resize needs integer ratio, got {h}x{w} -> {out_h}x{out_w}")
    return x[..., ::h // out_h, ::w // out_w, :]


def _resample_crop(dms, top, left, bottom, right, out_h: int, out_w: int):
    """Crop ``[top:bottom, left:right]``, center-pad to a square of side
    ``le``, legacy-bilinear-resize to ``(out_h, out_w)``, as one masked
    bilinear gather.

    Args: dms (b, H, W) float32; top/left/bottom/right (b,) int32.
    Returns: (cropped (b, out_h, out_w, 1), le, oh, ow).
    """
    b, h_in, w_in = dms.shape
    dev = dms.device
    hbox = bottom - top
    wbox = right - left
    le = torch.maximum(hbox, wbox)
    oh = ((le - hbox).to(torch.float32) / 2.0).to(torch.int32)
    ow = ((le - wbox).to(torch.float32) / 2.0).to(torch.int32)

    lef = le.to(torch.float32)[:, None]
    # arange * le / out, in this order: floor() of it picks the taps
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)[None] * lef / out_h
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)[None] * lef / out_w
    hi = (le - 1)[:, None]
    y0 = torch.minimum(torch.floor(ys).to(torch.int32).clamp_min(0), hi)
    x0 = torch.minimum(torch.floor(xs).to(torch.int32).clamp_min(0), hi)
    y1 = torch.minimum(y0 + 1, hi)
    x1 = torch.minimum(x0 + 1, hi)
    fy = (ys - y0.to(torch.float32))[:, :, None]
    fx = (xs - x0.to(torch.float32))[:, None, :]

    flat_dm = dms.reshape(b, h_in * w_in)
    oh_, ow_ = oh[:, None], ow[:, None]
    top_, left_ = top[:, None], left[:, None]

    def tap(yy, xx):
        """Padded image P[yy, xx] for yy (b, out_h), xx (b, out_w)."""
        yv = (yy >= oh_) & (yy < oh_ + hbox[:, None])
        xv = (xx >= ow_) & (xx < ow_ + wbox[:, None])
        sy = (yy - oh_ + top_).clamp(0, h_in - 1)
        sx = (xx - ow_ + left_).clamp(0, w_in - 1)
        idx = (sy[:, :, None] * w_in + sx[:, None, :]).reshape(b, -1)
        vals = torch.gather(flat_dm, 1, idx.to(torch.int64))
        vals = vals.reshape(b, out_h, out_w)
        return torch.where(yv[:, :, None] & xv[:, None, :], vals, 0.0)

    tl = tap(y0, x0)
    tr = tap(y0, x1)
    bl = tap(y1, x0)
    br = tap(y1, x1)
    t = tl + (tr - tl) * fx
    bo = bl + (br - bl) * fx
    out = t + (bo - t) * fy
    return out[..., None], le, oh, ow


def _new_cfg(cfg, top, left, le, oh, ow, out_h: int, out_w: int):
    """Post-crop intrinsics ``(b, 6)`` from the frame's ``cfg`` ``(6,)``."""
    ratio_x = le.to(torch.float32) / out_w
    ratio_y = le.to(torch.float32) / out_h
    f32 = lambda v: v.to(torch.float32)
    return torch.stack([
        cfg[0] / ratio_x,
        cfg[1] / ratio_y,
        (cfg[2] - f32(left) + f32(ow)) / ratio_x,
        (cfg[3] - f32(top) + f32(oh)) / ratio_y,
        torch.full_like(ratio_x, out_w),
        torch.full_like(ratio_x, out_h),
    ], dim=-1)


def _bbox_from_pose(poses: torch.Tensor, cfg: torch.Tensor, pad: float):
    """Pose-driven boxes ``(top, left, bottom, right)``, each ``(b,)``
    int32 (truncated toward zero): the joints' projected extent plus
    ``pad`` pixels, held inside the frame and at least ``2 pad`` wide.

    Args: poses (b, 3j) xyz mm; cfg (6,) intrinsics of the full frame.
    """
    b = poses.shape[0]
    uvd = geometry.xyz2uvd(poses, cfg).reshape(b, -1, 3)
    min_c = uvd.amin(dim=1)
    max_c = uvd.amax(dim=1)
    h, w = cfg[5], cfg[4]
    top = torch.minimum((min_c[:, 1] - pad).clamp_min(0.0), h - 2 * pad)
    left = torch.minimum((min_c[:, 0] - pad).clamp_min(0.0), w - 2 * pad)
    bottom = torch.maximum(torch.minimum(max_c[:, 1] + pad, h),
                           top + 2 * pad - 1)
    right = torch.maximum(torch.minimum(max_c[:, 0] + pad, w),
                          left + 2 * pad - 1)
    return tuple(v.to(torch.int32) for v in (top, left, bottom, right))


def crop_from_xyz_pose(dms: torch.Tensor, poses: torch.Tensor,
                       cfg: torch.Tensor, out_h: int, out_w: int,
                       pad: float = 20.0,
                       fixed_bg_threshold: Optional[float] = None):
    """Crop the hand around its pose, with the background cull: pixels at
    or beyond ``min(joint depth > 100 mm) + 250`` (or a dataset's fixed
    threshold) are zeroed. The joint depths are read at the clipped,
    truncated joint projections.

    Args:
      dms: (b, H, W, 1) or (b, H, W) raw depth, mm (float32 or uint16).
      poses: (b, 3j) xyz mm. cfg: (6,) intrinsics of the full frame.
    Returns:
      (cropped (b, out_h, out_w, 1) float32 mm, cfgs (b, 6)).
    """
    dms = dms.to(torch.float32)
    if dms.ndim == 4:
        dms = dms[..., 0]
    cfg = cfg.to(torch.float32)
    b, h_in, w_in = dms.shape
    top, left, bottom, right = _bbox_from_pose(poses, cfg, pad)
    cropped, le, oh, ow = _resample_crop(dms, top, left, bottom, right,
                                         out_h, out_w)
    if fixed_bg_threshold is not None:
        d_th = torch.full((b,), float(fixed_bg_threshold),
                          dtype=torch.float32, device=dms.device)
    else:
        uvd = geometry.xyz2uvd(poses, cfg).reshape(b, -1, 3)
        uu = uvd[..., 0].to(torch.int32).clamp(0, w_in - 1)
        vv = uvd[..., 1].to(torch.int32).clamp(0, h_in - 1)
        dd = torch.gather(dms.reshape(b, -1), 1,
                          (vv * w_in + uu).to(torch.int64))
        dd = torch.where(dd > 100.0, dd, torch.full_like(dd, float("inf")))
        d_th = dd.amin(dim=1) + 250.0
    cropped = torch.where(cropped < d_th[:, None, None, None], cropped, 0.0)
    return cropped, _new_cfg(cfg, top, left, le, oh, ow, out_h, out_w)


def preprocess_batch_from_pose(dms: torch.Tensor, poses: torch.Tensor,
                               cfg: torch.Tensor, out_h: int, out_w: int,
                               fixed_bg_threshold: Optional[float] = None):
    """Train-style preprocess of a batch: crop around the (ground-truth)
    pose, then the center of mass, on the device the frames lie on.

    Args: dms (b, H, W, 1) raw depth (uint16 or float32, cast on the
      device); poses (b, 3j); cfg (6,).
    Returns: (cropped (b, h, w, 1) mm, poses, cfgs (b, 6), coms (b, 3)).
    """
    poses = poses.to(torch.float32)
    cropped, cfgs = crop_from_xyz_pose(dms, poses, cfg, out_h, out_w,
                                       fixed_bg_threshold=fixed_bg_threshold)
    return cropped, poses, cfgs, center_of_mass(cropped, cfgs)


def preprocess_batch_from_bbx(dms: torch.Tensor, poses: torch.Tensor,
                              bbxs: torch.Tensor, cfg: torch.Tensor,
                              out_h: int, out_w: int):
    """Test-style preprocess from stored boxes (NYU's test split): crop
    from the boxes, then the center of mass. Returns as
    :func:`preprocess_batch_from_pose`."""
    cropped, cfgs = crop_from_bbx(dms, bbxs, cfg, out_h, out_w)
    return cropped, poses.to(torch.float32), cfgs, center_of_mass(cropped,
                                                                  cfgs)


def crop_from_bbx(dms: torch.Tensor, bbxs: torch.Tensor, cfg: torch.Tensor,
                  out_h: int, out_w: int):
    """Crop driven by stored bounding boxes and a depth threshold.

    Args:
      dms: (b, H, W, 1) or (b, H, W) raw depth, mm (float32 or uint16).
      bbxs: (b, 5) = (top, left, bottom, right, depth_threshold); the box
        edges are truncated toward zero.
      cfg: (6,) intrinsics of the full frame.
    Returns:
      (cropped (b, out_h, out_w, 1) float32 mm, cfgs (b, 6)).
    """
    dms = dms.to(torch.float32)
    if dms.ndim == 4:
        dms = dms[..., 0]
    bbxs = bbxs.to(torch.float32)
    cfg = cfg.to(torch.float32)
    top, left, bottom, right = (bbxs[:, k].to(torch.int32) for k in range(4))
    cropped, le, oh, ow = _resample_crop(dms, top, left, bottom, right,
                                         out_h, out_w)
    cropped = torch.where(cropped < bbxs[:, 4, None, None, None], cropped, 0.0)
    return cropped, _new_cfg(cfg, top, left, le, oh, ow, out_h, out_w)


def center_of_mass(dms: torch.Tensor, cfgs: torch.Tensor) -> torch.Tensor:
    """Hand center ``(b, 3)``: mean valid depth back-projected through the
    image-center ray, depth floored at 200 mm (an all-invalid map gives
    com_z = 200).

    Args: dms (b, h, w, 1) cropped depth mm; cfgs (b, 6).
    """
    h, w = dms.shape[1], dms.shape[2]
    d = dms.reshape(dms.shape[0], -1)
    valid = d > 0.0
    cnt = valid.sum(dim=1).clamp_min(1)
    ave_d = torch.where(valid, d, 0.0).sum(dim=1) / cnt.to(torch.float32)
    ave_d = ave_d.clamp_min(200.0)
    ave_x = (w / 2 - cfgs[:, 2]) * ave_d / cfgs[:, 0]
    ave_y = (h / 2 - cfgs[:, 3]) * ave_d / cfgs[:, 1]
    return torch.stack([ave_x, ave_y, ave_d], dim=-1)


def norm_dm(dms: torch.Tensor, coms: torch.Tensor) -> torch.Tensor:
    """Normalize depth into the com-centred window: ``(d - (com_z - R/2)) /
    R`` inside ``(com_z - R, com_z + R/2)``, else -1 (R = 300 mm).

    Args: dms (b, h, w, 1); coms (b, 3).
    """
    com_z = coms[:, 2, None, None, None]
    max_depth = com_z + D_RANGE * 0.5
    min_depth = com_z - D_RANGE * 0.5
    mask = (dms < max_depth) & (dms > min_depth - D_RANGE * 0.5)
    return torch.where(mask, (dms - min_depth) / D_RANGE, -1.0)
