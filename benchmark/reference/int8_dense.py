"""The paper's stacked-hourglass net ``um_v1`` in calibrated int8, as plain
functions over a flat weight dict.

``um_v1`` is ``reference.net``'s topology, paths and padding, with every
convolution dense: each residual bottleneck's 3x3 is a full convolution
over its channels (not ``reference.lite``'s depthwise one). The int8 form
is ``reference.lite``'s post-training quantization, which follows the JAX
package's (``models/quantize.py``, ``models/layers.py``): per-output-channel
symmetric int8 weights, per-tensor activation scales from one calibrating
pass, exact int32 sums, ``y = float32(acc) * (s_x * s_w) + bias``, ReLU,
each rounded once in float32, and a consumer's quantization ``clip(round(y
/ s_y), -127, 127)``. What this file adds is its form's convolution: its
kind is its kernel's, ``k3_dense`` for a 1x1 stride-1 convolution and
``k3_implicit`` for any other (the program's K3 entries), never
depthwise. The forward (``lite.forward``), the fold and the weights'
quantization (``lite.fold``, ``lite.quantize_weights``), the serving
pipeline around the net (``lite.predict``) and the maxima's comparison
(``lite.amax_gap_rel``) are ``reference.lite``'s, which hold for any net of
this topology.

Departures from the JAX package, none of which moves a value: the layout
is NCHW; a quantized activation is carried as its float result and its
producer's scale, and each convolution that reads it quantizes it again
(the JAX package hands on the producer's int8 tensor: the same values,
since rounding is monotone and max pooling and nearest upsampling commute
with it); a 1x1 convolution is a matrix product and a k x k one a matrix
product of its unfolded patches (im2col), both in float64, whose sums of
int8 products are exact while they stay under 2^53 (at most 2,304 x 127^2
here); no convolution library, which may pick transform algorithms; only
float32 views are written (the configuration's).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from . import lite

Tensors = lite.Tensors


def kind(k: int, stride: int) -> str:
    """The K3 entry that runs a k x k convolution of ``stride``:
    ``k3_dense`` (1x1, stride 1) or ``k3_implicit`` (the implicit GEMM)."""
    return "k3_dense" if k == 1 and stride == 1 else "k3_implicit"


class Int8Form(lite.Int8Form):
    """``lite.Int8Form`` with every convolution dense, by its kernel's
    kind; ``steps["dw"]`` stays 0."""

    def conv(self, path, x, stride=1, bn=True, relu=True):
        if isinstance(x, lite.Act):
            s_x, xf = x.s, x.f
        else:
            xf = x
            s_x = self._scale(f"{path}/amax", xf)
            self.steps["quantize"] += 1
        x_q = self._quant(xf, s_x).double()
        k_q = self.p[f"{path}/kernel_q"].double()
        k = k_q.shape[-1]
        step = kind(k, stride)
        self.steps[step] += 1
        b, c, h, w = x_q.shape
        if step == "k3_dense":
            acc = (x_q.permute(0, 2, 3, 1).reshape(-1, c)
                   @ k_q[:, :, 0, 0].t())
            acc = acc.view(b, h, w, -1).permute(0, 3, 1, 2)
        else:
            oh, ow = -(-h // stride), -(-w // stride)
            cols = F.unfold(lite._pad(x_q, k, stride), k,
                            stride=stride)                # (b, c k k, L)
            acc = (k_q.reshape(k_q.shape[0], -1) @ cols).view(b, -1, oh, ow)
        scale = s_x * self.p[f"{path}/scale"]
        y = acc.float() * scale.view(1, -1, 1, 1)
        y = y + self.p[f"{path}/bias"].view(1, -1, 1, 1)
        if relu:
            y = torch.clamp_min(y, 0.0)
        return self._tagged(path, y)      # the epilogue's quantization


@torch.no_grad()
def calibrate(cfg: dict, qparams: Tensors, normed: torch.Tensor,
              levels: int = 127) -> Tensors:
    """The activation maxima of one calibrating pass over ``normed``
    ``(b, H, W, 1)``, the whole calibration batch at once, as the
    program's predictor takes it."""
    stats: Tensors = {}
    lite.forward(Int8Form(qparams, stats, calibrating=True, levels=levels),
                 cfg, normed)
    return stats


def int8_forward(qparams: Tensors, stats: Tensors,
                 levels: int = 127) -> Callable:
    """The calibrated int8 net as a function of normalized depth, for
    ``lite.predict``."""
    return lambda cfg, dms: lite.forward(Int8Form(qparams, stats,
                                                  levels=levels), cfg, dms)
