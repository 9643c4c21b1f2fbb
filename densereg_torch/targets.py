"""Training targets: 2D cone heatmaps, 3D offset maps, 3D closeness
heatmaps and unit-offset maps.

Mirrors ``densereg_tpu/targets.py``: every map is one broadcast expression
over ``(b, h, w, j)``, NHWC like the net's heads, on the device the inputs
lie on. ``um_xy_angle`` and ``um_z_component`` draw the unit offsets for
the debug images; ``gaussian_heatmaps`` is the legacy per-point target.
"""

from __future__ import annotations

import torch

from densereg_torch import geometry
from densereg_torch.config import MAX_DIST_2D, MAX_DIST_3D
from densereg_torch.preprocess import method2_resize


def hm2d(poses: torch.Tensor, cfgs: torch.Tensor, out_h: int,
         out_w: int) -> torch.Tensor:
    """Cone heatmaps ``max(0, R - dist2d((u, v), pixel)) / R``, R = 4 px,
    after projecting the pose with intrinsics rescaled to the heatmap grid.

    Args: poses (b, 3j) xyz mm; cfgs (b, 6). Returns (b, out_h, out_w, j).
    """
    b = poses.shape[0]
    j = poses.shape[1] // 3
    scaled = geometry.scale_cfg(cfgs, out_w, out_h)
    uvd = geometry.xyz2uvd(poses, scaled).reshape(b, j, 3)
    uu = uvd[:, None, None, :, 0]
    vv = uvd[:, None, None, :, 1]
    col = torch.arange(out_w, dtype=poses.dtype,
                       device=poses.device)[None, None, :, None]
    row = torch.arange(out_h, dtype=poses.dtype,
                       device=poses.device)[None, :, None, None]
    dist = torch.sqrt(torch.square(col - uu) + torch.square(row - vv))
    return torch.clamp_min(MAX_DIST_2D - dist, 0.0) / MAX_DIST_2D


def offset_maps(normed_poses: torch.Tensor, xyzs: torch.Tensor) -> torch.Tensor:
    """Per-pixel offsets pixel -> joint, channels ``[x0, y0, z0, x1, ...]``.

    Args: normed_poses (b, 3j); xyzs (b, h, w, 3) normalized point cloud.
    Returns (b, h, w, 3j).
    """
    j = normed_poses.shape[-1] // 3
    return normed_poses[:, None, None, :] - xyzs.repeat(1, 1, 1, j)


def hm3d(oms: torch.Tensor) -> torch.Tensor:
    """3D closeness ``max(0, (R3 - |offset|) / R3)``, R3 = 0.8 (80 mm).

    Args: oms (b, h, w, 3j). Returns (b, h, w, j).
    """
    b, h, w, c = oms.shape
    o = oms.reshape(b, h, w, c // 3, 3)
    mag = torch.sqrt(torch.sum(torch.square(o), dim=-1))
    return torch.clamp_min((MAX_DIST_3D - mag) / MAX_DIST_3D, 0.0)


def unit_offset_maps(oms: torch.Tensor, hm3: torch.Tensor) -> torch.Tensor:
    """``om / d`` where ``d = R3 (1 - hm3)`` lies below ``R3 - 1e-2``, else
    0: the magnitude comes from ``hm3``, as in the reference, so that
    ``(hm3, um)`` stays consistent with :func:`resume_offset_maps`.

    Args: oms (b, h, w, 3j); hm3 (b, h, w, j). Returns (b, h, w, 3j).
    """
    b, h, w, c = oms.shape
    j = c // 3
    d = MAX_DIST_3D - hm3 * MAX_DIST_3D
    mask = d < (MAX_DIST_3D - 1e-2)
    o = oms.reshape(b, h, w, j, 3)
    safe_d = torch.where(mask, d, torch.ones_like(d))[..., None]
    um = torch.where(mask[..., None], o / safe_d, torch.zeros_like(o))
    return um.reshape(b, h, w, c)


def resume_offset_maps(hm3: torch.Tensor, um: torch.Tensor) -> torch.Tensor:
    """Offsets back from (3D heatmap, unit offsets): ``um * R3 (1 - hm3)``."""
    b, h, w, c = um.shape
    j = c // 3
    d = MAX_DIST_3D - hm3 * MAX_DIST_3D
    return (um.reshape(b, h, w, j, 3) * d[..., None]).reshape(b, h, w, c)


def synthesize(poses: torch.Tensor, cfgs: torch.Tensor, coms: torch.Tensor,
               normed_dms: torch.Tensor, out_h: int, out_w: int) -> dict:
    """Every training target of one micro-batch.

    Args:
      poses (b, 3j) xyz mm; cfgs (b, 6); coms (b, 3);
      normed_dms (b, H, W, 1) normalized depth at the net's input size.
    Returns:
      ``{"hm2" (b,h,w,j), "hm3" (b,h,w,j), "um" (b,h,w,3j), "om"
      (b,h,w,3j), "tiny_dm" (b,h,w,1)}``.
    """
    gt_hm2 = hm2d(poses, cfgs, out_h, out_w)
    normed_poses = geometry.norm_xyz_pose(poses, coms)
    tiny_dm = method2_resize(normed_dms, out_h, out_w)
    xyzs = geometry.backproject_dm(tiny_dm, cfgs, coms)
    om = offset_maps(normed_poses, xyzs)
    hm3 = hm3d(om)
    um = unit_offset_maps(om, hm3)
    return {"hm2": gt_hm2, "hm3": hm3, "um": um, "om": om, "tiny_dm": tiny_dm}


def um_z_component(ums: torch.Tensor) -> torch.Tensor:
    """The z component of each joint's unit offsets (the reference's
    ``_vis_um_z``). Args: ums (b, h, w, 3j). Returns (b, h, w, j)."""
    b, h, w, c = ums.shape
    return ums.reshape(b, h, w, c // 3, 3)[..., 2]


def gaussian_heatmaps(uvd: torch.Tensor, out_h: int, out_w: int,
                      sigma: float = 3.0) -> torch.Tensor:
    """Per-point Gaussian heatmaps, the legacy/bigHand target path: the
    normalized Gaussian bump ``exp(-d^2 / (2 sigma^2))`` (peak 1) at each
    point, clipped to the grid.

    Args: uvd (..., 3j) or (..., j, 3). Returns (..., out_h, out_w, j).
    """
    pts = (uvd.reshape(uvd.shape[:-1] + (-1, 3)) if uvd.shape[-1] != 3
           else uvd)
    uu = pts[..., 0].clamp(0, out_w - 1)
    vv = pts[..., 1].clamp(0, out_h - 1)
    col = torch.arange(out_w, dtype=uvd.dtype, device=uvd.device)
    row = torch.arange(out_h, dtype=uvd.dtype, device=uvd.device)
    d2 = (torch.square(col[None, :, None] - uu[..., None, None, :])
          + torch.square(row[:, None, None] - vv[..., None, None, :]))
    return torch.exp(-d2 / (2.0 * sigma * sigma))


def um_xy_angle(ums: torch.Tensor) -> torch.Tensor:
    """The xy-plane angle of unit-offset maps, for the debug images (the
    reference's ``_vis_um_xy``): ``sin(x / |xy|)`` where the vector is
    long enough to mean something, 1 elsewhere; the denominator is clamped
    (the reference divides unguarded and gives NaN on pure-z vectors).

    Args: ums (b, h, w, 3j). Returns (b, h, w, j).
    """
    b, h, w, c = ums.shape
    u = ums.reshape(b, h, w, c // 3, 3)
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    d = torch.sqrt(x * x + y * y)
    small = (d * d + z * z) < 0.1
    safe_d = torch.clamp_min(d, 1e-6)
    return torch.where(small, torch.ones_like(x), torch.sin(x / safe_d))
