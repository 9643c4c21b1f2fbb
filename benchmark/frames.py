"""Seeded synthetic depth frames at a configuration's camera and joint
count, rendered on the device in bulk.

A scene is a blobby "hand": a sphere at each joint of a random cluster in
front of an empty background (depth 0), as the program's synthetic dataset
draws them: center x ~ U(-60, 60), y ~ U(-40, 40), z ~ U(330, 470) mm;
joints at offsets U(-55, 55), U(-55, 55), U(-35, 35) mm; radii U(12, 22) mm.
Depth is uint16 mm, truncated. Each frame also gets a box around its
projected joints, ``(top, left, bottom, right, depth_threshold)``, the
layout of NYU's stored test boxes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def render(n: int, camera: dict, jnt: int, gen: torch.Generator,
           device, chunk: int = 32) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """``(depth (n, H, W) uint16, poses (n, 3 jnt) float32 mm, boxes (n, 5)
    float32)`` on the host, drawn from ``gen`` (on ``device``)."""
    fx, fy, cx, cy = (camera[k] for k in ("fx", "fy", "cx", "cy"))
    h, w = int(camera["h"]), int(camera["w"])
    u = torch.rand((n, 3 + 4 * jnt), generator=gen, device=device,
                   dtype=torch.float64)
    center = torch.stack([u[:, 0] * 120 - 60, u[:, 1] * 80 - 40,
                          u[:, 2] * 140 + 330], -1)
    off = u[:, 3:3 + 3 * jnt].view(n, jnt, 3)
    off = off * torch.tensor([110.0, 110.0, 70.0], device=device,
                             dtype=torch.float64) - torch.tensor(
        [55.0, 55.0, 35.0], device=device, dtype=torch.float64)
    joints = center[:, None, :] + off
    radius = u[:, 3 + 3 * jnt:] * 10 + 12
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    depth = np.empty((n, h, w), np.uint16)
    for s in range(0, n, chunk):
        jt = joints[s:s + chunk].float()
        rr = radius[s:s + chunk].float()
        zbuf = torch.full((jt.shape[0], h, w), float("inf"), device=device)
        for j in range(jnt):
            x, y, z = (jt[:, j, k].view(-1, 1, 1) for k in range(3))
            r = rr[:, j].view(-1, 1, 1)
            d2 = (xx - (x * fx / z + cx)) ** 2 + (yy - (y * fy / z + cy)) ** 2
            inside = d2 < (r * fx / z) ** 2
            zj = z - torch.sqrt(torch.clamp_min(r * r - d2 * (z / fx) ** 2,
                                                0.0))
            zbuf = torch.where(inside & (zj < zbuf), zj, zbuf)
        frame = torch.where(torch.isinf(zbuf), torch.zeros_like(zbuf), zbuf)
        depth[s:s + chunk] = frame.to(torch.int32).cpu().numpy()
    pts = joints.float()
    uu = pts[..., 0] * fx / pts[..., 2] + cx
    vv = pts[..., 1] * fy / pts[..., 2] + cy
    margin = (radius.float() * fx / pts[..., 2]).amax(1) + 8.0
    boxes = torch.stack([
        (vv.amin(1) - margin).clamp(0, h - 2),
        (uu.amin(1) - margin).clamp(0, w - 2),
        (vv.amax(1) + margin).clamp(2, h),
        (uu.amax(1) + margin).clamp(2, w),
        pts[..., 2].amax(1) + 50.0], -1)
    return (depth, pts.reshape(n, -1).cpu().numpy().astype(np.float32),
            boxes.cpu().numpy().astype(np.float32))
