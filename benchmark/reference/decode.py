"""Vote decoding, plain: dense head outputs -> 3D joint positions.

A frozen copy of plain torch code. Arithmetic follows the reference decode
operation by operation (same association, no fused multiply-add), and
subnormal float32 values are flushed to zero (:func:`flush_subnormals`), as
XLA computes: a mean-shift Gaussian weight that underflows below 2^-126
counts for nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import geometry
from .constants import MAX_DIST_3D, POSE_NORM_RATIO


class DecodeConfig:
    """The decode's settings (denseReg's test defaults)."""

    num_candidates = 5
    mean_shift_iters = 10
    band_width = 0.4
    vote_grid = 4


def decode_xyz(hms, hm3s, ums, tiny_dms, cfgs, coms) -> torch.Tensor:
    """The decode to joints in camera mm, ``(b, 3j)``."""
    normed = decode_plain(hms, hm3s, ums, tiny_dms, cfgs, coms)[0]
    return geometry.unnorm_xyz_pose(normed.reshape(hms.shape[0], -1), coms)


# the smallest normal float32
_FLT_MIN = torch.finfo(torch.float32).tiny


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """Each subnormal element of ``x`` as a zero of its sign: what XLA's
    float32 arithmetic does on the CPU and the TPU (FTZ on results, DAZ on
    inputs), applied to a tensor, without touching torch's process-wide
    ``set_flush_denormal``. NaN and infinities pass."""
    return torch.where(x.abs() < _FLT_MIN, x * 0.0, x)


def _trunc_int32(x: torch.Tensor) -> torch.Tensor:
    """``x.astype(int32)`` as XLA and CUDA do it: toward zero, saturating,
    NaN -> 0. (A float -> int cast of NaN or inf is undefined in torch.)"""
    x = torch.nan_to_num(x, nan=0.0, posinf=1e9, neginf=-1e9)
    return x.clamp(-1e9, 1e9).to(torch.int32)


def refined_heatmaps(hms, hm3s, tiny_dms):
    """Candidate-selection score ``(hm + 1) * hm3 * valid(dm)``; all
    ``(b, h, w, ·)``."""
    mask = torch.where(tiny_dms < -0.99, 0.0, 1.0)
    return (hms + 1.0) * hm3s * mask


def top_k_first_index(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last axis, ties to the
    lower index (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]




def candidate_weights(cans, coms, cfgs, hms):
    """Reprojection weight of each candidate: ``hm`` at its rounded pixel
    on the head grid, 0 off-image.

    (The reference also computes a z-clamped copy of the candidates and
    discards it; that copy is not built here.)

    Args:
      cans: (b, j, n, 3) normalized candidates; coms (b, 3); cfgs (b, 6);
      hms: (b, h, w, j).
    Returns: weights (b, j, n).
    """
    b, h, w, j = hms.shape
    xyz_mm = cans * POSE_NORM_RATIO + coms[:, None, None, :]
    scaled = geometry.scale_cfg(cfgs, w, h)
    uvd = geometry.xyz2uvd(xyz_mm.reshape(b, -1), scaled).reshape(b, j, -1, 3)
    uu = _trunc_int32(uvd[..., 0] + 0.5)
    vv = _trunc_int32(uvd[..., 1] + 0.5)
    inb = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
    flat = vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)
    hm_flat = hms.reshape(b, h * w, j).transpose(1, 2)
    weights = torch.gather(hm_flat, 2, flat.to(torch.int64))
    return torch.where(inb, weights, 0.0)


def _vote_grid_init(cans, weights, grid: int = 4):
    """Mean-shift start: the center of the LAST maximal cell of a
    ``grid``^3 weighted vote over [-1, 1]^3 (row-major order).

    cans (..., n, 3); weights (..., n). Returns (..., 3).
    """
    num_quan = grid // 2
    q = (cans + 1.0) * num_quan
    q = _trunc_int32(torch.nan_to_num(q, nan=0.0).clamp(0.0, grid - 0.1))
    flat = (q[..., 0] * grid + q[..., 1]) * grid + q[..., 2]
    onehot = F.one_hot(flat.to(torch.int64), grid ** 3).to(weights.dtype)
    votes = _sum_in_order(weights[..., None] * onehot, dim=-2)
    last = (grid ** 3 - 1) - torch.argmax(votes.flip(-1), dim=-1)
    iz = last % grid
    iy = (last // grid) % grid
    ix = last // (grid * grid)
    return (torch.stack([ix, iy, iz], dim=-1).to(cans.dtype) / num_quan
            - 1.0 + 0.5 / num_quan)


def weighted_mean_shift(cans, weights, num_it: int, band_width: float,
                        grid: int = 4):
    """Weighted Gaussian mean shift from the voting-grid start; where every
    weight is 0 the grid estimate is kept (the reference divides 0/0).
    Every float32 result is flushed to zero where it is subnormal, inputs
    too (:func:`flush_subnormals`), as XLA computes: a Gaussian weight
    that underflows adds nothing, and a sum of such weights is 0, so the
    estimate stays.

    cans (..., n, 3); weights (..., n). Returns (..., 3).
    """
    ftz = flush_subnormals
    inv_sigma = -1.0 / (2.0 * band_width * band_width)
    cans, weights = ftz(cans), ftz(weights)
    cur = _vote_grid_init(cans, weights, grid)
    for _ in range(num_it):
        sq = ftz(torch.square(ftz(cans - cur[..., None, :])))
        d2 = ftz(ftz(sq[..., 0] + sq[..., 1]) + sq[..., 2])
        s = ftz(ftz(torch.exp(ftz(inv_sigma * d2))) * weights)
        num = _sum_in_order(ftz(cans * s[..., None]), dim=-2)
        den = _sum_in_order(s, dim=-1)[..., None]
        ok = den > 0.0
        cur = torch.where(ok, ftz(num / torch.where(ok, den, 1.0)), cur)
    return cur




def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` from first to last element, the order in which the
    fused kernel sums its candidates (a reduction kernel picks its own
    order, and over ten mean-shift steps the rounding adds up); each
    partial sum goes through :func:`flush_subnormals`."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = flush_subnormals(acc + p)
    return acc


def decode_plain(hms, hm3s, ums, tiny_dms, cfgs, coms,
                 cfg=None):
    """The decode in plain torch: top-k first, then the offsets at the k
    picks only. Returns ``(normed (b, j, 3), candidates (b, j, n, 3),
    weights (b, j, n))``."""
    cfg = DecodeConfig() if cfg is None else cfg
    b, h, w, j = hms.shape
    hw = h * w
    # XLA's DAZ on the heads and the depth, FTZ on the scores and candidates
    hms, hm3s, ums, tiny_dms = (flush_subnormals(t)
                                for t in (hms, hm3s, ums, tiny_dms))
    xyzs = geometry.backproject_dm(tiny_dms, cfgs, coms)            # (b,h,w,3)
    refined = flush_subnormals(refined_heatmaps(hms, hm3s, tiny_dms))
    top_idx = top_k_first_index(refined.reshape(b, hw, j).transpose(1, 2),
                                cfg.num_candidates)                  # (b,j,n)
    idx3 = top_idx[..., None].expand(-1, -1, -1, 3)
    xyz_sel = torch.gather(xyzs.reshape(b, 1, hw, 3).expand(-1, j, -1, -1),
                           2, idx3)
    hm3_sel = torch.gather(hm3s.reshape(b, hw, j).transpose(1, 2), 2, top_idx)
    um_sel = torch.gather(ums.reshape(b, hw, j, 3).transpose(1, 2), 2, idx3)
    dist = flush_subnormals(MAX_DIST_3D - hm3_sel * MAX_DIST_3D)
    cans = flush_subnormals(xyz_sel + flush_subnormals(um_sel
                                                       * dist[..., None]))
    weights = candidate_weights(cans, coms, cfgs, hms)
    normed = weighted_mean_shift(cans, weights, cfg.mean_shift_iters,
                                 cfg.band_width, cfg.vote_grid)
    return normed, cans, weights
