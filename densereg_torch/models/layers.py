"""Building blocks of the stacked hourglass, NCHW, eval form.

Mirrors ``densereg_tpu/models/layers.py``. Parameter names follow the Flax
tree (``conv/{kernel,bias}``, ``bn/{gamma,beta}`` with moving statistics
``bn/{mean,var}``) so that ``models.bridge`` maps one onto the other. Kernels
are stored OIHW.

Padding is XLA's ``SAME``: for a stride-2 window on an even input it is
uneven (the 7x7/2 stem pads 2 before and 3 after, a 3x3/2 pool 0 and 1), so
it is applied explicitly, never through symmetric ``padding=``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, window: int, stride: int):
    """(before, after) padding of XLA's SAME for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


class BatchRenorm(nn.Module):
    """Batch renormalization in eval form: ``(x - mean) / sqrt(var + eps) *
    gamma + beta`` in float32 with the moving statistics, cast back to the
    input's dtype. (Training form waits for the training slice.)"""

    def __init__(self, channels: int, epsilon: float = 1e-3):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x):
        view = lambda t: t.float().view(1, -1, 1, 1)
        y = (x.float() - view(self.mean)) / torch.sqrt(view(self.var)
                                                      + self.epsilon)
        return (y * view(self.gamma) + view(self.beta)).to(x.dtype)


class Conv(nn.Module):
    """2-D convolution with SAME padding; ``kernel`` is OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 use_bias: bool = True, groups: int = 1):
        super().__init__()
        self.stride = stride
        self.groups = groups
        self.kernel = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x):
        k = self.kernel.shape[-1]
        ph = same_pads(x.shape[-2], k, self.stride)
        pw = same_pads(x.shape[-1], k, self.stride)
        kernel = self.kernel.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, kernel, bias, self.stride, (ph[0], pw[0]),
                            groups=self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, kernel, bias, self.stride, groups=self.groups)


class ConvBR(nn.Module):
    """conv -> [batch renorm | bias] -> [ReLU]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, use_bn: bool = True, relu: bool = True,
                 groups: int = 1, bn_epsilon: float = 1e-3):
        super().__init__()
        self.conv = Conv(in_ch, out_ch, kernel, stride, use_bias=not use_bn,
                         groups=groups)
        self.bn = BatchRenorm(out_ch, bn_epsilon) if use_bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class Residual(nn.Module):
    """Bottleneck residual: 1x1 (in/2) -> kxk (in/2) -> 1x1 (out), each
    conv + renorm + ReLU, plus the identity (or a 1x1 conv + renorm + ReLU
    projection when the width changes). The sum has no activation."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 kernel_size: int = 3, use_bn: bool = True,
                 bn_epsilon: float = 1e-3):
        super().__init__()
        out_ch = in_ch if out_ch is None else out_ch
        half = in_ch // 2
        conv = lambda i, o, k: ConvBR(i, o, k, use_bn=use_bn,
                                      bn_epsilon=bn_epsilon)
        self.conv1 = conv(in_ch, half, 1)
        self.conv2 = conv(half, half, kernel_size)
        self.conv3 = conv(half, out_ch, 1)
        self.shortcut = conv(in_ch, out_ch, 1) if out_ch != in_ch else None

    def forward(self, x):
        y = self.conv3(self.conv2(self.conv1(x)))
        return y + (x if self.shortcut is None else self.shortcut(x))


def max_pool_same(x, window: int, stride: int):
    """Max pool with SAME padding (padded with -inf) on NCHW."""
    ph = same_pads(x.shape[-2], window, stride)
    pw = same_pads(x.shape[-1], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def upsample_nearest_2x(x):
    """Nearest x2 upsample on NCHW (pure replication)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
