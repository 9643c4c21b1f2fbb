"""Weights across the two packages: the JAX package's Flax variable tree
(nested dicts of arrays, module names as ``densereg_tpu/models/hourglass.py``
and ``layers.py`` write them) to a :class:`DenseRegNet` and back
(:func:`to_flax`), and seeded Flax-layout trees made without JAX: one
calibrated for serving tests (:func:`init_variables`), one drawn as the
JAX package's training init (:func:`init_train_variables`).

A Flax path ``stem_conv/conv/kernel`` is the torch state-dict key
``stem_conv.conv.kernel``; batch statistics ``batch_stats/<path>/bn/mean``
are the buffers ``<path>.bn.mean``. Kernels go from HWIO to OIHW.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from densereg_torch.config import NetConfig
from densereg_torch.models.hourglass import (
    DenseRegNet,
    refuse_calibrated_deconv,
)
from densereg_torch.models.layers import BatchRenorm, ConvBR
from densereg_torch.models.ops import Deconv


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "."))
        else:
            flat[path] = np.asarray(val)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, val in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return tree


def is_folded(variables) -> bool:
    return not variables.get("batch_stats")


def is_quantized(variables) -> bool:
    """Whether the tree is an int8 one (``models.quantize.quantize_weights``)."""
    return any(k.endswith(".kernel_q") for k in _flatten(variables["params"]))


def from_flax(variables, net_cfg: NetConfig) -> DenseRegNet:
    """Build a :class:`DenseRegNet` from ``{"params", "batch_stats"}``, from
    a folded ``{"params"}`` (``models.fold.fold_batch_norm``), or from an
    int8 ``{"params"}`` (``models.quantize.quantize_weights``) with, when
    calibrated, its ``act_stats`` collection (``amax``/``out_amax``).

    ``net_cfg.fold_bn`` and ``net_cfg.quantize`` are set from the tree.
    Every leaf is consumed exactly once: a missing or left-over key raises
    ``KeyError``. ``kernel_q`` stays int8 and HWIO; float kernels become
    float32 OIHW.
    """
    folded = is_folded(variables)
    quantized = is_quantized(variables)
    if quantized and variables.get("act_stats"):
        refuse_calibrated_deconv(net_cfg)
    net = DenseRegNet(dataclasses.replace(net_cfg, fold_bn=folded,
                                          quantize=quantized))
    flat = _flatten(variables["params"])
    if not folded:
        flat.update(_flatten(variables["batch_stats"]))
    stats = _flatten(variables.get("act_stats", {}))
    for key, val in stats.items():
        path, leaf = key.rsplit(".", 1)
        try:
            mod = net.get_submodule(path) if quantized else None
        except AttributeError:
            mod = None
        if leaf not in ("amax", "out_amax") or not hasattr(mod, leaf):
            raise KeyError(f"act_stats leaf {key} matches no int8 layer")
        setattr(mod, leaf, torch.tensor(float(val), dtype=torch.float32))
    want = {k: v for k, v in net.state_dict().items() if k not in stats}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"Flax tree does not match DenseRegNet({net.cfg}): "
                       f"missing {missing[:8]}{'...' if len(missing) > 8 else ''}, "
                       f"left over {extra[:8]}{'...' if len(extra) > 8 else ''}")
    state = {}
    for key, ref in want.items():
        if key.endswith(".kernel_q"):
            val = flat[key].astype(np.int8)
        else:
            val = flat[key].astype(np.float32)
        if key.endswith(".kernel"):
            val = val.transpose(3, 2, 0, 1)
        if val.shape != tuple(ref.shape):
            raise ValueError(f"{key}: shape {val.shape}, DenseRegNet wants "
                             f"{tuple(ref.shape)}")
        state[key] = torch.from_numpy(np.ascontiguousarray(val))
    net.load_state_dict(state, strict=False)
    return net.eval()


def flax_tree(tensors) -> dict:
    """A ``{state-dict key: tensor}`` mapping of a float :class:`DenseRegNet`
    (its state dict, or gradients keyed like its parameters) as a Flax-layout
    nested dict of float32 numpy arrays, kernels HWIO."""
    flat = {}
    for key, t in tensors.items():
        val = t.detach().float().cpu().numpy().copy()
        if key.endswith(".kernel"):
            val = val.transpose(2, 3, 1, 0)
        flat[key] = val
    return _unflatten(flat)


def to_flax(net: DenseRegNet) -> dict:
    """The float (unquantized) net's weights as the JAX package's variables:
    ``{"params", "batch_stats"}`` of numpy arrays (``{"params"}`` for a
    folded net), the inverse of :func:`from_flax`."""
    if net.cfg.quantize:
        raise NotImplementedError("to_flax takes a float net")
    stats = {k: v for k, v in net.state_dict().items()
             if k.endswith((".mean", ".var"))}
    out = {"params": flax_tree(dict(net.named_parameters()))}
    if not net.cfg.fold_bn:
        out["batch_stats"] = flax_tree(stats)
    return out


def init_train_variables(net_cfg: NetConfig, seed: int = 0) -> dict:
    """The JAX package's training init (``models/layers.py:135-158``) drawn
    from a numpy seed, with no JAX: every kernel a standard normal truncated
    to [-2, 2] times 0.01 (std about 0.0088), biases and beta 0, gamma 1,
    moving mean 0 and variance 1. Returns ``{"params", "batch_stats"}`` in
    Flax layout."""
    rng = np.random.default_rng(seed)
    net = DenseRegNet(dataclasses.replace(net_cfg, fold_bn=False,
                                          quantize=False))
    state = {}
    for key, t in net.state_dict().items():
        if key.endswith(".kernel"):
            val = rng.standard_normal(tuple(t.shape))
            while True:             # redraw what lies outside [-2, 2]
                out = np.abs(val) > 2.0
                if not out.any():
                    break
                val[out] = rng.standard_normal(int(out.sum()))
            state[key] = torch.from_numpy((val * 0.01).astype(np.float32))
        else:
            state[key] = t          # zeros and ones as constructed
    params = {k: v for k, v in state.items()
              if not k.endswith((".mean", ".var"))}
    stats = {k: v for k, v in state.items() if k.endswith((".mean", ".var"))}
    return {"params": flax_tree(params), "batch_stats": flax_tree(stats)}


def act_stats_to_flax(net: DenseRegNet) -> dict:
    """The recorded calibration statistics of an int8 net as the JAX
    package's ``act_stats`` collection: a nested dict of float32 scalars."""
    flat = {}
    for path, mod in net.named_modules():
        for leaf in ("amax", "out_amax"):
            val = getattr(mod, leaf, None)
            if isinstance(val, torch.Tensor):
                flat[f"{path}.{leaf}"] = np.float32(val.item())
    return _unflatten(flat)


def seeded_depth(rng, b: int, h: int, w: int) -> np.ndarray:
    """Normalized depth maps shaped like hand crops: a tilted surface in
    (0, 1) with noise, background (-1) outside an ellipse."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.empty((b, h, w, 1), np.float32)
    for i in range(b):
        cy, cx = rng.uniform(0.4, 0.6, 2) * (h, w)
        ry, rx = rng.uniform(0.25, 0.45, 2) * (h, w)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        surf = (0.5 + 0.2 * (yy - cy) / h - 0.1 * (xx - cx) / w
                + rng.normal(0.0, 0.02, (h, w)))
        out[i, ..., 0] = np.where(inside, surf, -1.0)
    return out


def init_variables(net_cfg: NetConfig, seed: int = 0) -> dict:
    """A random unfolded ``{"params", "batch_stats"}`` tree in Flax layout,
    from a numpy seed, with no JAX.

    Kernels are He-scaled (std sqrt(2 / fan_in)), biases small, gamma near
    1 and beta near 0. On a batch of eight seeded hand-like depth maps, the
    moving statistics are set to the per-channel moments that each renorm
    layer sees (the variance raised by a tenth of the layer's mean variance,
    so no channel divides by a near-zero spread). Each convolution without
    renorm is scaled to a unit output std, except the ``hm`` and ``hm3``
    heads, which are set per channel to mean 0.5 and std 0.25, a trained
    net's range, and a ``Deconv`` (``um_v1_deconv``), scaled to its
    input's std: every head is O(1) on such inputs. (The training init, std
    0.01 and zero biases, shrinks the activations toward 0 through the ~140
    convolutions, and the decode then sees only ties; He kernels with
    arbitrary statistics grow them by orders of magnitude instead.)
    """
    rng = np.random.default_rng(seed)
    net = DenseRegNet(dataclasses.replace(net_cfg, fold_bn=False,
                                          compute_dtype="float32")).eval()
    state = {}
    for key, t in net.state_dict().items():
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "kernel":
            o, i, kh, kw = shape
            val = rng.normal(0.0, np.sqrt(2.0 / (i * kh * kw)), shape)
        elif leaf in ("bias", "beta"):
            val = rng.normal(0.0, 0.05, shape)
        elif leaf == "gamma":
            val = rng.uniform(0.8, 1.2, shape)
        elif leaf in ("mean", "var"):
            val = np.full(shape, 0.0 if leaf == "mean" else 1.0)
        else:
            raise KeyError(f"init_variables: no rule for {key}")
        state[key] = torch.from_numpy(val.astype(np.float32))
    net.load_state_dict(state)

    def set_stats(bn, args):
        x = args[0].double()
        bn.mean.copy_(x.mean(dim=(0, 2, 3)))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        bn.var.copy_(var + 0.1 * var.mean() + 1e-4)

    def unit_std(conv_br, args):
        conv = conv_br.conv
        y = conv(args[0]) - conv.bias.view(1, -1, 1, 1)
        conv.kernel.div_(y.std())

    def head_range(mean, std):
        """Per channel: output mean ``mean`` and spread ``std`` on the
        calibration batch (plus the small random bias)."""
        def hook(conv_br, args):
            conv = conv_br.conv
            y = conv(args[0]) - conv.bias.view(1, -1, 1, 1)
            scale = std / y.std(dim=(0, 2, 3))
            conv.kernel.mul_(scale.view(-1, 1, 1, 1))
            conv.bias.add_(mean - y.mean(dim=(0, 2, 3)) * scale)
        return hook

    def like_input(deconv, args):
        """A learned upsample that keeps its input's spread, as the nearest
        one does (the float net hands it NCHW)."""
        conv = deconv.ConvTranspose_0
        y = conv(args[0]) - conv.bias.view(1, -1, 1, 1)
        conv.kernel.mul_(args[0].std() / y.std())

    hooks = [m.register_forward_pre_hook(set_stats) for m in net.modules()
             if isinstance(m, BatchRenorm)]
    hooks += [m.register_forward_pre_hook(like_input) for m in net.modules()
              if isinstance(m, Deconv)]
    # convolutions without renorm are scaled to a unit output std instead,
    # except the heatmap heads, which are set to a trained net's range: hm
    # and hm3 mostly in [0, 1], so that the decode's weights (hm at the
    # reprojections) are mostly positive and their sum is not near 0, where
    # the weighted mean shift would amplify any rounding of the heads
    ranges = {"hm_head": (0.5, 0.25), "hm3_head": (0.5, 0.25)}
    for name, m in net.named_modules():
        if isinstance(m, ConvBR) and m.bn is None:
            kind = name.rsplit("_s", 1)[0]
            hook = head_range(*ranges[kind]) if kind in ranges else unit_std
            hooks.append(m.register_forward_pre_hook(hook))
    h, w = net_cfg.input_hw
    with torch.inference_mode():
        net(torch.from_numpy(seeded_depth(rng, 8, h, w)))
    for hook in hooks:
        hook.remove()

    params, stats = {}, {}
    for key, t in net.state_dict().items():
        val = t.numpy().copy()
        if key.endswith(".kernel"):
            val = val.transpose(2, 3, 1, 0)
        (stats if key.endswith((".mean", ".var")) else params)[key] = val
    return {"params": _unflatten(params), "batch_stats": _unflatten(stats)}
