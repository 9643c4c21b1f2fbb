"""Post-training int8 quantization for serving.

Mirrors ``densereg_tpu/models/quantize.py``. It turns a BN-folded serving
tree (``models.fold.fold_batch_norm``) into the int8 form that the
``quantized`` layers take:

* weights: symmetric per output channel, ``kernel_q = round(k / s_w)``
  with ``s_w = max|k| / 127`` over (h, w, in) (over (h, w, 1) for a
  depthwise kernel); a ``Deconv``'s transposed convolution
  (``deconv_up/ConvTranspose_0``, no ``conv`` key) stays float, as in JAX;
* activations: per-tensor symmetric scales, static once :func:`calibrate`
  has recorded each layer's running ``max|x|`` (the ``act_stats`` of the
  JAX package, buffers ``amax``/``out_amax`` here), else dynamic per
  batch;
* int32 sums on the int8 GEMM kernel, then scale, bias and ReLU in
  float32.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from densereg_torch.config import NetConfig
from densereg_torch.models.hourglass import refuse_calibrated_deconv


def quantize_weights(folded_variables):
    """``{"params"}`` of a ``fold_bn`` tree (numpy arrays, Flax layout) ->
    ``{"params"}`` of the int8 net: each ``conv/{kernel, bias}`` becomes
    ``{kernel_q (HWIO int8), scale (s_w, float32), bias}``."""
    def walk(node):
        out = {}
        for key, val in node.items():
            if not isinstance(val, dict):
                out[key] = val
            elif "conv" in val and set(val["conv"]) >= {"kernel", "bias"}:
                k = np.asarray(val["conv"]["kernel"], np.float32)
                s_w = (np.maximum(np.abs(k).max(axis=(0, 1, 2)),
                                  np.float32(1e-8)) / np.float32(127.0))
                k_q = np.clip(np.round(k / s_w), -127, 127).astype(np.int8)
                out[key] = {"kernel_q": k_q, "scale": s_w,
                            "bias": np.asarray(val["conv"]["bias"],
                                               np.float32)}
            else:
                out[key] = walk(val)
        return out

    return {"params": walk(folded_variables["params"])}


def quantized_net_config(cfg: NetConfig) -> NetConfig:
    return dataclasses.replace(cfg, fold_bn=True, quantize=True)


@torch.inference_mode()
def calibrate(net: torch.nn.Module, batches: Iterable[torch.Tensor]):
    """Record each int8 layer's activation ``max|x|`` over ``batches`` of
    normalized depth (the net's input), as a running max that carries over
    from earlier calls. While a batch runs, each layer quantizes with that
    batch's own max, as the JAX package's calibration does. Afterwards the
    net serves with static scales. Returns ``net``, updated in place. A
    ``um_v1_deconv`` net raises ``NotImplementedError``
    (``models.hourglass.refuse_calibrated_deconv``)."""
    mods = [m for m in net.modules() if hasattr(m, "calibrating")]
    if not mods:
        raise ValueError("calibrate needs an int8 net (NetConfig.quantize)")
    refuse_calibrated_deconv(net.cfg)
    try:
        for m in mods:
            m.calibrating = True
        for dms in batches:
            net(dms)
    finally:
        for m in mods:
            m.calibrating = False
    return net
