"""The serving path of the reference: raw frames and boxes in, joints in
camera mm out, in blocks of rows so that it fits beside anything."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import net
from .decode import decode_xyz
from .preprocess import center_of_mass, crop_from_bbx, method2_resize, norm_dm


@torch.no_grad()
def predict(cfg: dict, folded: Dict[str, torch.Tensor], frames: np.ndarray,
            boxes: np.ndarray, cam: torch.Tensor, dtype: torch.dtype,
            block: int = 256, round_operands=None,
            tf32: bool = False) -> np.ndarray:
    """``frames`` ``(n, H, W)`` raw depth mm, ``boxes`` ``(n, 5)``; the
    folded weights (``net.fold``) on the device the work runs on. Returns
    ``(n, 3j)`` float32. ``round_operands`` (``net.Ctx``) or ``tf32`` (the
    libraries' TF32 switched on) makes it a control in a lower
    precision."""
    dev = cam.device
    size = cfg["input_size"]
    ctx = net.Ctx(folded, "eval", dtype, round_operands=round_operands)
    out = []
    with net.tf32_switch(tf32):
        for s in range(0, len(frames), block):
            dms = torch.from_numpy(np.ascontiguousarray(
                frames[s:s + block])).to(dev)
            bbx = torch.from_numpy(np.asarray(boxes[s:s + block],
                                              np.float32)).to(dev)
            crops, cfgs = crop_from_bbx(dms, bbx, cam, size, size)
            coms = center_of_mass(crops, cfgs)
            normed = norm_dm(crops, coms)
            heads = net.forward(ctx, cfg, normed)
            tiny = method2_resize(normed, size // 4, size // 4)
            out.append(decode_xyz(heads["hm"][-1], heads["hm3"][-1],
                                  heads["um"][-1], tiny, cfgs, coms)
                       .cpu().numpy())
    return np.concatenate(out)


def normed_crops(cfg: dict, frames: np.ndarray, boxes: np.ndarray,
                 cam: torch.Tensor) -> torch.Tensor:
    """The net's input for ``frames``: crop from the boxes, center of mass,
    normalization."""
    dev = cam.device
    size = cfg["input_size"]
    crops, cfgs = crop_from_bbx(torch.from_numpy(frames).to(dev),
                                torch.from_numpy(boxes).to(dev), cam, size,
                                size)
    return norm_dm(crops, center_of_mass(crops, cfgs))
