"""Inference over pre-cropped batches: normalize -> network -> decode.

Mirrors ``make_infer_fn`` of ``densereg_tpu/eval/loop.py`` (the rest of
that module, the evaluation stream and its result dumps, waits for the eval
slice).
"""

from __future__ import annotations

from typing import Callable

import torch

from densereg_torch import decode as decode_mod
from densereg_torch.config import EvalConfig, NetConfig
from densereg_torch.models import DenseRegNet, from_flax
from densereg_torch.preprocess import method2_resize, norm_dm


def make_infer_fn(net_cfg: NetConfig, ecfg: EvalConfig = EvalConfig(),
                  device="cuda") -> Callable:
    """Returns ``infer(variables_or_module, dms, cfgs, coms)`` -> xyz
    ``(b, 3j)`` mm on ``device``.

    ``dms`` are raw-mm cropped depth maps ``(b, H, W, 1)`` (float32 or
    uint16; arrays or tensors); ``cfgs`` ``(b, 6)``; ``coms`` ``(b, 3)``.
    ``variables_or_module`` is a :class:`DenseRegNet` on ``device`` or a
    Flax-layout tree, which is converted (``models.from_flax``) on every
    call: pass the module where calls repeat.
    """
    device = torch.device(device)
    out_h, out_w = net_cfg.output_hw

    @torch.inference_mode()
    def infer(variables_or_module, dms, cfgs, coms):
        net = variables_or_module
        if not isinstance(net, DenseRegNet):
            net = from_flax(net, net_cfg).to(device)
        dms = torch.as_tensor(dms, device=device).to(torch.float32)
        cfgs = torch.as_tensor(cfgs, dtype=torch.float32, device=device)
        coms = torch.as_tensor(coms, dtype=torch.float32, device=device)
        normed = norm_dm(dms, coms)
        outs = net(normed)
        tiny = method2_resize(normed, out_h, out_w)
        res = decode_mod.decode_poses(outs["hm"][-1], outs["hm3"][-1],
                                      outs["um"][-1], tiny, cfgs, coms, ecfg)
        return res["xyz"]

    return infer
