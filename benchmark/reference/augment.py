"""Data augmentation: a random in-plane rotation and anisotropic scale per
frame, batched over the frame axis.

The pose and the image share one 2x2
map about the projected center of mass (the crop's center), and the image
is resampled by one nearest-neighbour gather per pixel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import geometry


def _affine_params(b: int, generator: Optional[torch.Generator] = None,
                   device=None):
    """Per frame: angle ~ U(-pi, pi) ``(b,)`` and ratio ``(b, 2)`` =
    (height, width) ~ clip(N(1, 0.2), 0.9, 1.1), drawn from ``generator``
    (on ``device``)."""
    angle = (torch.rand((b,), generator=generator, device=device)
             * (2.0 * math.pi) - math.pi)
    ratio = torch.clamp(1.0 + 0.2 * torch.randn((b, 2), generator=generator,
                                                device=device), 0.9, 1.1)
    return angle, ratio


def _transform_pose_uv(uv: torch.Tensor, angle: torch.Tensor,
                       ratio: torch.Tensor, center: torch.Tensor):
    """Forward map of uv points ``(b, n, 2)``: rotate by -angle, then scale
    (u by the width ratio, v by the height ratio), about ``center``
    ``(b, 2)``; angle ``(b,)``, ratio ``(b, 2)``."""
    rel = uv - center[:, None, :]
    cos, sin = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    u = (rel[..., 0] * cos + rel[..., 1] * sin) * ratio[:, 1:2]
    v = (-rel[..., 0] * sin + rel[..., 1] * cos) * ratio[:, 0:1]
    return torch.stack([u, v], dim=-1) + center[:, None, :]


def _source_indices(h: int, w: int, angle: torch.Tensor, ratio: torch.Tensor,
                    center: torch.Tensor):
    """Integer source pixel ``(iy, ix)``, each ``(b, h, w)`` int32, of every
    output pixel under the inverse map (unscale, then rotate back), rounded
    half to even. Indices outside the image are kept as they are; the warp
    reads zeros there."""
    dev = angle.device
    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    qx = (torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
          - center[:, 0, None, None])
    qy = (torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
          - center[:, 1, None, None])
    ux = qx / ratio[:, 1, None, None]
    uy = qy / ratio[:, 0, None, None]
    sx = ux * cos - uy * sin + center[:, 0, None, None]
    sy = ux * sin + uy * cos + center[:, 1, None, None]
    return torch.round(sy).to(torch.int32), torch.round(sx).to(torch.int32)


def warp_image(dms: torch.Tensor, angle: torch.Tensor, ratio: torch.Tensor,
               center: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour warp ``out(q) = in(M^-1 q)``, zeros outside the
    image, by a gather. dms ``(b, h, w, 1)``."""
    b, h, w = dms.shape[:3]
    iy, ix = _source_indices(h, w, angle, ratio, center)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    vals = torch.gather(dms.reshape(b, h * w), 1,
                        idx.reshape(b, -1).to(torch.int64)).reshape(b, h, w)
    return torch.where(valid, vals, torch.zeros_like(vals))[..., None]




def augment_batch(dms: torch.Tensor, poses: torch.Tensor, cfgs: torch.Tensor,
                  coms: torch.Tensor,
                  generator: Optional[torch.Generator] = None):
    """Augment a batch, each frame with its own angle and ratio.

    Args:
      dms (b, h, w, 1) cropped raw depth, mm; poses (b, 3j) xyz mm;
      cfgs (b, 6) crop intrinsics; coms (b, 3) xyz mm; generator on the
      tensors' device.
    Returns: (augmented dms, augmented poses).
    """
    b = dms.shape[0]
    angle, ratio = _affine_params(b, generator, dms.device)
    return augment_with(dms, poses, cfgs, coms, angle, ratio)


def augment_with(dms, poses, cfgs, coms, angle, ratio):
    """:func:`augment_batch` with the angles ``(b,)`` and ratios ``(b, 2)``
    given."""
    b = dms.shape[0]
    uv_com = geometry.xyz2uvd(coms, cfgs)[:, :2]
    uvd = geometry.xyz2uvd(poses, cfgs).reshape(b, -1, 3)
    new_uv = _transform_pose_uv(uvd[..., :2], angle, ratio, uv_com)
    new_uvd = torch.cat([new_uv, uvd[..., 2:3]], dim=-1).reshape(b, -1)
    new_poses = geometry.uvd2xyz(new_uvd, cfgs)
    return warp_image(dms, angle, ratio, uv_com), new_poses
