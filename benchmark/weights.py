"""Seeded weights, made on the device in a few large draws from one
``torch.Generator``, and handed alike to the program (as the Flax-layout
tree of numpy arrays that its loaders take) and to the reference.

* Serving weights: He-scaled kernels, small biases and betas, gammas near
  1, then one calibrating pass of the reference net over normalized crops
  of the cell's own frames that sets every renorm's moving statistics to
  the moments it sees and scales each convolution without renorm to a unit
  output spread; the ``hm`` and ``hm3`` heads are set per channel to mean
  0.5 and spread 0.25, a trained net's range, so that the decode's votes
  are mostly positive and not tied. A net drawn without that pass grows or
  shrinks its activations by orders of magnitude through ~140
  convolutions, and its decode sees only ties.
* Training weights: the reference's training init, every kernel a
  standard normal truncated to [-2, 2] times 0.01, biases and betas 0,
  gammas 1, moving mean 0 and variance 1.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from reference import net

Tensors = Dict[str, torch.Tensor]


def _split(flat: torch.Tensor, shapes: Dict[str, tuple]) -> Tensors:
    sizes = [int(np.prod(s)) for s in shapes.values()]
    return {k: v.view(s) for (k, s), v in zip(shapes.items(),
                                              flat.split(sizes))}


def serving_weights(cfg: dict, gen: torch.Generator,
                    normed_crops: torch.Tensor) -> Tuple[Tensors, Tensors]:
    """``(params, stats)`` in float32 on ``normed_crops``' device,
    calibrated on ``normed_crops`` ``(b, H, W, 1)`` (the net's input)."""
    dev = normed_crops.device
    pshapes, sshapes = net.param_shapes(cfg)
    kernels = {k: s for k, s in pshapes.items() if k.endswith("/kernel")}
    shifts = {k: s for k, s in pshapes.items()
              if k.endswith(("/bias", "/beta"))}
    gammas = {k: s for k, s in pshapes.items() if k.endswith("/gamma")}
    params = _split(torch.randn(sum(int(np.prod(s)) for s in kernels.values()),
                                generator=gen, device=dev), kernels)
    for k, t in params.items():
        o, i, kh, kw = t.shape
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

    with torch.no_grad():
        net.forward(net.Ctx(params, "calibrate", stats=stats, hook=scale),
                    cfg, normed_crops)
    return params, stats


def training_weights(cfg: dict, gen: torch.Generator,
                     device) -> Tuple[Tensors, Tensors]:
    """``(params, stats)``, the training init, in float32 on ``device``."""
    pshapes, sshapes = net.param_shapes(cfg)
    kernels = {k: s for k, s in pshapes.items() if k.endswith("/kernel")}
    flat = torch.randn(sum(int(np.prod(s)) for s in kernels.values()),
                       generator=gen, device=device)
    while True:                     # redraw what lies outside [-2, 2]
        out = flat.abs() > 2.0
        n = int(out.sum())
        if not n:
            break
        flat[out] = torch.randn(n, generator=gen, device=device)
    params = _split(flat * 0.01, kernels)
    for k, s in pshapes.items():
        if k not in params:
            params[k] = (torch.ones(s, device=device) if k.endswith("gamma")
                         else torch.zeros(s, device=device))
    params = {k: params[k] for k in pshapes}
    stats = {k: torch.zeros(s, device=device) if k.endswith("mean")
             else torch.ones(s, device=device) for k, s in sshapes.items()}
    return params, stats


def flax_tree(params: Tensors, stats: Tensors) -> dict:
    """``{"params", "batch_stats"}`` as nested dicts of float32 numpy
    arrays, kernels HWIO: the layout the program's loaders read."""
    def nest(flat):
        tree: dict = {}
        for path, t in flat.items():
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            val = t.detach().float().cpu().numpy()
            node[leaf] = (val.transpose(2, 3, 1, 0) if leaf == "kernel"
                          else val).copy()
        return tree
    return {"params": nest(params), "batch_stats": nest(stats)}
