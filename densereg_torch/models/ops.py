"""The slim op vocabulary in torch: the counterpart of
``densereg_tpu/models/ops.py``, with its names.

:class:`Deconv` is the learned upsampling of the ``um_v1_deconv`` net
variant (``models/hourglass.py``); the other layers (``DepthwiseConv``,
``Fc``) and the stateless functions are the rest of the vocabulary that the
JAX module keeps. Like the JAX ones they take NHWC (features last), except
``Deconv``, which also takes the float net's NCHW (``channels_last=False``).
Parameter names follow Flax's (a submodule ``ConvTranspose_0``, ``Conv_0``
or ``Dense_0`` holding ``kernel`` and ``bias``), so ``models.bridge`` maps
them one to one; convolution kernels are stored OIHW, as the port's others.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from densereg_torch.models.layers import (  # re-exported, as in JAX
    BatchRenorm,
    Conv,
    ConvBR,
    max_pool_same,
    same_pads,
    upsample_nearest_2x,
)

__all__ = [
    "ConvBR", "BatchRenorm", "DepthwiseConv", "Deconv", "Fc",
    "max_pool", "avg_pool", "upsampling_nearest", "dropout",
    "flatten", "one_hot_encoding", "repeat_op", "conv_transpose_pads",
]


def conv_transpose_pads(k: int, s: int):
    """(before, after) padding of ``lax.conv_transpose``'s SAME on the
    stride-dilated input: ``k + s - 2`` in all, ``k - 1`` before when
    ``s > k - 1``, else half of it rounded up. The output is ``s`` times
    the input."""
    total = k + s - 2
    before = k - 1 if s > k - 1 else math.ceil(total / 2)
    return before, total - before


class _ConvTranspose(nn.Module):
    """Flax's ``nn.ConvTranspose(padding="SAME")`` (``transpose_kernel``
    False): a correlation of the stride-dilated input, padded by
    :func:`conv_transpose_pads`, with ``kernel`` as it stands. ``kernel``
    is kept OIHW, as the bridge turns any Flax HWIO kernel; the flip and the
    (in, out) layout that ``F.conv_transpose2d`` wants happen here, so the
    bridge needs no rule of its own."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int):
        super().__init__()
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(features, in_ch, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):                       # NCHW
        k, s = self.kernel.shape[-1], self.stride
        before, after = conv_transpose_pads(k, s)
        # conv_transpose2d pads the dilated input by k - 1 on each side
        # (plus output_padding after); crop to SAME's window
        extra = max(after - (k - 1), 0)
        w = self.kernel.to(x.dtype).transpose(0, 1).flip(2, 3)
        y = F.conv_transpose2d(x, w, self.bias.to(x.dtype), stride=s,
                               output_padding=extra)
        h, wd = x.shape[-2] * s, x.shape[-1] * s
        o = k - 1 - before
        return y[..., o:o + h, o:o + wd]


class Deconv(nn.Module):
    """Transposed convolution, stride 2 by default, SAME (slim ``deconv``;
    ``densereg_tpu/models/ops.py::Deconv``), with an optional ReLU. Its
    parameters are ``ConvTranspose_0.{kernel, bias}``, as in Flax."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3,
                 stride: int = 2, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.ConvTranspose_0 = _ConvTranspose(in_ch, features, kernel, stride)

    def forward(self, x, channels_last: bool = True):
        if channels_last:
            y = self.ConvTranspose_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            y = self.ConvTranspose_0(x)
        return F.relu(y) if self.relu else y


class DepthwiseConv(nn.Module):
    """Depthwise convolution (slim ``depthwise_conv2d``): ``in_ch *
    channel_multiplier`` filters, one group a channel, SAME, with an
    optional ReLU; NHWC. Parameters ``Conv_0.{kernel, bias}``."""

    def __init__(self, in_ch: int, channel_multiplier: int = 1,
                 kernel: int = 3, stride: int = 1, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.Conv_0 = Conv(in_ch, in_ch * channel_multiplier, kernel, stride,
                           groups=in_ch)

    def forward(self, x):
        y = self.Conv_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return F.relu(y) if self.relu else y


class _Dense(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return x @ self.kernel.to(x.dtype) + self.bias.to(x.dtype)


class Fc(nn.Module):
    """Fully connected (slim ``fc``), with an optional ReLU. Parameters
    ``Dense_0.{kernel (in, out), bias}``, as Flax's ``nn.Dense``."""

    def __init__(self, in_features: int, features: int, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.Dense_0 = _Dense(in_features, features)

    def forward(self, x):
        y = self.Dense_0(x)
        return F.relu(y) if self.relu else y


def max_pool(x, window: int = 2, stride: int = 2):
    """SAME max pool of NHWC ``x`` (padded with -inf)."""
    return max_pool_same(x, window, stride, channels_last=True)


def avg_pool(x, window: int = 2, stride: int = 2):
    """SAME average pool of NHWC ``x``: each window's sum over the elements
    inside the input, divided by their count (the padding counts for
    nothing)."""
    ph = same_pads(x.shape[-3], window, stride)
    pw = same_pads(x.shape[-2], window, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
    ones = F.pad(torch.ones_like(x[..., :1]).permute(0, 3, 1, 2),
                 (pw[0], pw[1], ph[0], ph[1]))
    pool = lambda t: F.avg_pool2d(t, window, stride, divisor_override=1)
    return (pool(xp) / pool(ones)).permute(0, 2, 3, 1)


def upsampling_nearest(x, factor: int = 2):
    """Nearest upsample of NHWC ``x`` by a power of two."""
    if factor < 1 or factor & (factor - 1):
        raise ValueError("factor must be a power of two")
    for _ in range(factor.bit_length() - 1):
        x = upsample_nearest_2x(x, channels_last=True)
    return x


def dropout(x: torch.Tensor, rate: float = 0.5,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Keep each element with probability ``1 - rate`` and scale it by
    ``1 / (1 - rate)`` (Flax's ``nn.Dropout``); the mask is drawn from
    ``generator``, which lies on ``x``'s device (the default generator
    when None). A rate of 0 returns ``x``."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    if keep == 0.0:
        return torch.zeros_like(x)
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def flatten(x):
    return x.reshape(x.shape[0], -1)


def one_hot_encoding(labels, num_classes: int):
    """float32 one-hot rows; a label outside [0, num_classes) gives a row of
    zeros, as ``jax.nn.one_hot``."""
    labels = torch.as_tensor(labels)
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[..., None] == classes).to(torch.float32)


def repeat_op(repetitions: int, x, fn: Callable, *args, **kwargs):
    """Apply ``fn`` ``repetitions`` times (slim ``repeat_op``)."""
    for _ in range(repetitions):
        x = fn(x, *args, **kwargs)
    return x
