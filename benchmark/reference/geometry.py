"""Camera geometry: perspective projection and point-cloud back-projection.

Conventions: ``xyz`` in camera-space mm,
``uvd`` = (column, row, depth mm), ``cfg`` = ``(fx, fy, cx, cy, w, h)`` of
shape ``(6,)`` or ``(b, 6)``. Every function broadcasts over leading axes.
"""

from __future__ import annotations

import torch

from .constants import D_RANGE, POSE_NORM_RATIO


def xyz2uvd(xyz: torch.Tensor, cfg: torch.Tensor) -> torch.Tensor:
    """Perspective projection of ``(..., 3)`` or ``(..., 3j)`` points."""
    shape = xyz.shape
    pts = xyz.reshape(shape[:-1] + (-1, 3))
    cfg = cfg[..., None, :]
    u = pts[..., 0] * cfg[..., 0] / pts[..., 2] + cfg[..., 2]
    v = pts[..., 1] * cfg[..., 1] / pts[..., 2] + cfg[..., 3]
    return torch.stack([u, v, pts[..., 2]], dim=-1).reshape(shape)


def uvd2xyz(uvd: torch.Tensor, cfg: torch.Tensor) -> torch.Tensor:
    """Back-projection, inverse of :func:`xyz2uvd`."""
    shape = uvd.shape
    pts = uvd.reshape(shape[:-1] + (-1, 3))
    cfg = cfg[..., None, :]
    x = (pts[..., 0] - cfg[..., 2]) * pts[..., 2] / cfg[..., 0]
    y = (pts[..., 1] - cfg[..., 3]) * pts[..., 2] / cfg[..., 1]
    return torch.stack([x, y, pts[..., 2]], dim=-1).reshape(shape)


def scale_cfg(cfg: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """Rescale intrinsics for an image resized to ``(out_h, out_w)``."""
    w_ratio = cfg[..., 4] / out_w
    h_ratio = cfg[..., 5] / out_h
    return torch.stack([
        cfg[..., 0] / w_ratio,
        cfg[..., 1] / h_ratio,
        cfg[..., 2] / w_ratio,
        cfg[..., 3] / h_ratio,
        torch.full_like(cfg[..., 4], out_w),
        torch.full_like(cfg[..., 5], out_h),
    ], dim=-1)


def norm_xyz_pose(poses: torch.Tensor, coms: torch.Tensor) -> torch.Tensor:
    """``(pose - com) / POSE_NORM_RATIO`` per joint; poses ``(..., 3j)``,
    coms ``(..., 3)``."""
    shape = poses.shape
    p = poses.reshape(shape[:-1] + (-1, 3))
    return ((p - coms[..., None, :]) / POSE_NORM_RATIO).reshape(shape)


def unnorm_xyz_pose(normed: torch.Tensor, coms: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`norm_xyz_pose`."""
    shape = normed.shape
    p = normed.reshape(shape[:-1] + (-1, 3))
    return (p * POSE_NORM_RATIO + coms[..., None, :]).reshape(shape)


def backproject_dm(normed_dm: torch.Tensor, cfg: torch.Tensor,
                   com: torch.Tensor) -> torch.Tensor:
    """Normalized depth ``(b, h, w, 1)`` -> normalized point cloud
    ``(b, h, w, 3)``.

    ``cfg`` ``(b, 6)`` are the intrinsics of the full-resolution crop and are
    rescaled to the map's size; ``com`` is ``(b, 3)`` mm. Invalid pixels
    (``< -0.99``) land on the far plane ``com_z + D_RANGE / 2``.
    """
    b, h, w = normed_dm.shape[:3]
    zz = normed_dm[..., 0]
    min_depth = com[:, 2] - D_RANGE * 0.5
    max_depth = com[:, 2] + D_RANGE * 0.5
    zz = torch.where(zz < -0.99, max_depth[:, None, None],
                     zz * D_RANGE + min_depth[:, None, None])

    col = torch.arange(w, dtype=zz.dtype, device=zz.device)[None, None, :]
    row = torch.arange(h, dtype=zz.dtype, device=zz.device)[None, :, None]
    scaled = scale_cfg(cfg, w, h)
    fx, fy, cx, cy = (scaled[:, k][:, None, None] for k in range(4))
    xx = (col - cx) * zz / fx
    yy = (row - cy) * zz / fy
    com_b = com[:, None, None, :]
    return torch.stack([
        (xx - com_b[..., 0]) / POSE_NORM_RATIO,
        (yy - com_b[..., 1]) / POSE_NORM_RATIO,
        (zz - com_b[..., 2]) / POSE_NORM_RATIO,
    ], dim=-1)
