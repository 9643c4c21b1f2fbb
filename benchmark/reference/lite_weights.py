"""Seeded serving weights of the lite net (``reference.lite``), made as
``benchmark/weights.py`` makes the paper's net's: He-scaled kernels (a
depthwise kernel's fan-in is its window), small biases and betas, gammas
near 1, in a few large draws from one ``torch.Generator``; then one
calibrating pass of the unfolded lite net over normalized crops that sets
every renorm's moving statistics to the moments it sees and scales each
convolution without renorm to a unit output spread, with the ``hm`` and
``hm3`` heads set per channel to mean 0.5 and spread 0.25, a trained net's
range. ``weights.flax_tree`` hands them to the program (a depthwise
kernel ``(C, 1, k, k)`` becomes HWIO ``(k, k, 1, C)``, the JAX package's
layout)."""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import lite, net

Tensors = Dict[str, torch.Tensor]


def _split(flat: torch.Tensor, shapes: Dict[str, tuple]) -> Tensors:
    sizes = [int(np.prod(s)) for s in shapes.values()]
    return {k: v.view(s) for (k, s), v in zip(shapes.items(),
                                              flat.split(sizes))}


def serving_weights(cfg: dict, gen: torch.Generator,
                    normed_crops: torch.Tensor) -> Tuple[Tensors, Tensors]:
    """``(params, stats)`` of the unfolded lite net in float32 on
    ``normed_crops``' device, calibrated on ``normed_crops`` ``(b, H, W,
    1)`` (the net's input)."""
    dev = normed_crops.device
    pshapes, sshapes = lite.param_shapes(cfg)
    kernels = {k: s for k, s in pshapes.items() if k.endswith("/kernel")}
    shifts = {k: s for k, s in pshapes.items()
              if k.endswith(("/bias", "/beta"))}
    gammas = {k: s for k, s in pshapes.items() if k.endswith("/gamma")}
    params = _split(torch.randn(sum(int(np.prod(s)) for s in kernels.values()),
                                generator=gen, device=dev), kernels)
    for t in params.values():
        _, i, kh, kw = t.shape
        t.mul_(float(np.sqrt(2.0 / (i * kh * kw))))
    params.update(_split(0.05 * torch.randn(
        sum(int(np.prod(s)) for s in shifts.values()), generator=gen,
        device=dev), shifts))
    params.update(_split(0.8 + 0.4 * torch.rand(
        sum(int(np.prod(s)) for s in gammas.values()), generator=gen,
        device=dev), gammas))
    params = {k: params[k] for k in pshapes}
    stats = {k: torch.zeros(s, device=dev) if k.endswith("mean")
             else torch.ones(s, device=dev) for k, s in sshapes.items()}
    heads = ("hm_head", "hm3_head")

    def scale(path, x, y):
        kernel = params[f"{path}/conv/kernel"]
        bias = params[f"{path}/conv/bias"]
        y0 = y - bias.view(1, -1, 1, 1)
        if path.rsplit("_s", 1)[0] in heads:
            s = 0.25 / y0.std(dim=(0, 2, 3))
            bias.add_(0.5 - y0.mean(dim=(0, 2, 3)) * s)
        else:
            s = (1.0 / y0.std()).expand(kernel.shape[0])
        kernel.mul_(s.view(-1, 1, 1, 1))
        return y0 * s.view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)

    with torch.no_grad(), net.tf32_switch(False):
        lite.forward(lite.FloatForm(net.Ctx(params, "calibrate", stats=stats,
                                            hook=scale)), cfg, normed_crops)
    return params, stats
