"""Building blocks of the stacked hourglass: NCHW in float (training and
eval form), NHWC in int8.

Mirrors ``densereg_tpu/models/layers.py``. Parameter names follow the Flax
tree (``conv/{kernel,bias}``, ``bn/{gamma,beta}`` with moving statistics
``bn/{mean,var}``; int8 ``kernel_q``/``scale``/``bias`` and the calibrated
``amax``/``out_amax``) so that ``models.bridge`` maps one onto the other.
Float kernels are stored OIHW, int8 ones HWIO.

Padding is XLA's ``SAME``: for a stride-2 window on an even input it is
uneven (the 7x7/2 stem pads 2 before and 3 after, a 3x3/2 pool 0 and 1), so
it is applied explicitly, never through symmetric ``padding=``.

The int8 form (``quantized=True``, weights from
``models.quantize.quantize_weights``) runs channels-last: every convolution
is one launch of the int8 kernel K3 (``ops.int8_gemm``), its dense entry
over the activation itself for a 1x1 stride-1 convolution and its
implicit-GEMM entry, which reads the activation in place, otherwise; a
depthwise one (``um_v1_lite``'s middle convolution) is one launch of the
depthwise int8 kernel (``ops.int8_dwconv``).
Activations are quantized per tensor: with the scale of an incoming
:class:`QTensor`, else with the calibrated ``amax``, else with the batch's
own ``max|x|`` (dynamic). A calibrated layer also quantizes its own output
(``out_amax``) and hands on a :class:`QTensor`.

Each standalone quantization of an int8 forward (a convolution's own
quantize of a float input, and :func:`quantize_output` of a sum) runs
inside the span ``densereg.int8.quantize``; one fused into a kernel's
epilogue does not. :data:`int8_counts` counts the int8 forward's steps.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from densereg_torch.ops.int8_dwconv import int8_dwconv_requant, pack_dw_weight
from densereg_torch.ops.int8_gemm import (
    int8_conv_requant,
    int8_gemm_requant,
    pack_weight,
    quantize,
    same_pads,
)
from densereg_torch.utils.profiling import span

# what a calibrated int8 layer's consumers read of its output: the int8
# side (convolutions), the float side (sums, concatenations, heads) or both
OUT_USES = ("q", "f", "both")

# the int8 forwards' steps since the process started, read as differences:
# launches of K3 by entry (``k3_dense``, ``k3_implicit``) and of the
# depthwise kernel (``dw``), standalone quantize steps (``quantize``), and
# quantizations with a batch's own ``max|x|`` outside calibration
# (``dynamic``: 0 in a calibrated net)
int8_counts = dict.fromkeys(
    ("k3_dense", "k3_implicit", "dw", "quantize", "dynamic"), 0)


class QTensor:
    """A quantized NHWC activation between calibrated int8 layers: ``f`` the
    float result of the producing layer (in the compute dtype), ``q`` its
    int8 quantization with the per-tensor scale ``s`` (a 0-d float32
    tensor). Convolutions read ``q`` and ``s``; sums, concatenations and
    heads read ``f``. A producer whose consumers read one side only leaves
    the other None. No operator overloads: a site that was not taught about
    it fails loudly."""

    __slots__ = ("f", "q", "s")

    def __init__(self, f, q, s):
        self.f = f
        self.q = q
        self.s = s


def as_float(x):
    """The float view of a maybe-:class:`QTensor` value."""
    if isinstance(x, QTensor):
        if x.f is None:
            raise ValueError("QTensor has no float side: its producer was "
                             "told that only convolutions read it")
        return x.f
    return x


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127``, a 0-d float32 tensor on ``amax``'s device,
    by an IEEE division (a CUDA division by a Python number goes through
    the reciprocal)."""
    amax = torch.clamp_min(amax.float(), 1e-8)
    return amax / amax.new_full((), 127.0)


def _record_amax(mod: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    """While calibrating: this batch's ``max|x|``, kept as a running max in
    the buffer ``name``. Returns the batch's own value, which is what the
    layer quantizes with during calibration."""
    cur = x.float().abs().amax()
    old = getattr(mod, name)
    setattr(mod, name, cur if old is None else torch.maximum(old, cur))
    return cur


def quantize_output(mod: nn.Module, y: torch.Tensor, dtype: torch.dtype):
    """Producer-side quantization of a calibrated graph: a :class:`QTensor`
    of ``y`` with the module's ``out_amax`` (recorded while calibrating),
    its int8 pixels 16 bytes apart as K3 reads them; an uncalibrated module
    returns ``y`` in ``dtype``."""
    if not (mod.calibrating or mod.out_amax is not None):
        return y.to(dtype)
    int8_counts["quantize"] += 1
    with span("densereg.int8.quantize"):
        if mod.calibrating:
            s = act_scale(_record_amax(mod, "out_amax", y))
        else:
            s = act_scale(mod.out_amax)
        return QTensor(y.to(dtype), quantize(y, s, pitch16=True), s)


def _pmean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (``jax.lax.pmean``):
    the sum by a differentiable all-reduce, then a division by the number
    of ranks. ``t`` itself without a group."""
    if group is None:
        return t
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, op=dist.ReduceOp.SUM, group=group) / float(
        dist.get_world_size(group))


def pack_weights(net: nn.Module) -> nn.Module:
    """Bring the packed weights of every int8 convolution of ``net`` up to
    date with its ``kernel_q`` (eagerly); returns ``net``. Called before a
    trace, which cannot check them."""
    for mod in net.modules():
        if isinstance(mod, ConvBR) and mod.quantized:
            mod._packed_weight()
    return net


def sync_batch_renorm(net: nn.Module, group) -> nn.Module:
    """Set ``group`` on every :class:`BatchRenorm` of ``net`` (None turns
    the synchronization off); returns ``net``."""
    for mod in net.modules():
        if isinstance(mod, BatchRenorm):
            mod.group = group
    return net


class BatchRenorm(nn.Module):
    """Batch renormalization (``densereg_tpu/models/layers.py::BatchRenorm``)
    on NCHW, in float32, cast back to the input's dtype.

    Eval (``module.training`` False): ``(x - mean) / sqrt(var + eps) * gamma
    + beta`` with the moving statistics.

    Training: the batch moments over (b, h, w), two-pass (the mean, then the
    mean of squared deviations; biased), and

        y = ((x - mu_B) / sigma_B * r + d) * gamma + beta
        r = sg[clip(sigma_B / sigma_mov, 1/r_max, r_max)]
        d = sg[clip((mu_B - mu_mov) / sigma_mov, -d_max, d_max)]

    with ``r`` and ``d`` from the moving statistics as they stand before the
    call (``r = 1``, ``d = 0`` without ``r_max``); the moving statistics then
    move once, ``decay * moving + (1 - decay) * batch``, outside autograd.
    ``r_max`` and ``d_max`` are floats, or each a ``(low, high)`` pair of
    0-d float32 tensors on the input's device: the clip ranges
    ``[1/r_max, r_max]`` and ``[-d_max, d_max]`` rounded to float32 on the
    host (``train.state.renorm_clip_bounds``), the same values the floats
    clamp at, which a CUDA graph reads anew at each replay.

    ``replay``, when set to a ``(mean, var)`` pair (the moving statistics
    before the first pass), makes a training forward the recompute of a
    rematerialised one: ``r`` and ``d`` come from that pair and the moving
    statistics stay where the first pass left them.

    ``group``, a ``torch.distributed`` process group (set on a whole net by
    :func:`sync_batch_renorm`), makes the training moments those of the
    global batch over the group's ranks, two-pass as
    ``densereg_tpu/models/layers.py`` takes them under ``axis_name``: the
    mean of the local means, then the mean of the local variances about
    that mean (every rank holds the same number of frames). The
    all-reduces are differentiable, so the gradients are those of the
    global batch. A recompute (``replay``) all-reduces again, on every rank
    alike.
    """

    def __init__(self, channels: int, epsilon: float = 1e-3,
                 decay: float = 0.99):
        super().__init__()
        self.epsilon = epsilon
        self.decay = decay
        self.group = None
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.replay = None

    def forward(self, x, r_max=None, d_max=None):
        view = lambda t: t.float().view(1, -1, 1, 1)
        xf = x.float()
        if not self.training:
            y = (xf - view(self.mean)) / torch.sqrt(view(self.var)
                                                   + self.epsilon)
        else:
            mean = _pmean(xf.mean(dim=(0, 2, 3)), self.group)
            var = _pmean(torch.square(xf - mean.view(1, -1, 1, 1))
                         .mean(dim=(0, 2, 3)), self.group)
            std = torch.sqrt(var + self.epsilon)
            y = (xf - view(mean)) / view(std)
            mov_mean, mov_var = self.replay or (self.mean, self.var)
            if r_max is not None:
                with torch.no_grad():
                    mov_std = torch.sqrt(mov_var + self.epsilon)
                    r_lo, r_hi = (r_max if isinstance(r_max, tuple)
                                  else (1.0 / r_max, r_max))
                    d_lo, d_hi = (d_max if isinstance(d_max, tuple)
                                  else (-d_max, d_max))
                    r = torch.clamp(std / mov_std, r_lo, r_hi)
                    d = torch.clamp((mean - mov_mean) / mov_std, d_lo, d_hi)
                y = y * view(r) + view(d)
            if self.replay is None:
                with torch.no_grad():
                    self.mean.copy_(self.decay * self.mean
                                    + (1.0 - self.decay) * mean)
                    self.var.copy_(self.decay * self.var
                                   + (1.0 - self.decay) * var)
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
    """conv -> [batch renorm | bias] -> [ReLU].

    ``quantized=True`` builds the int8 form instead: buffers ``kernel_q``
    (HWIO int8, ``(k, k, in / groups, out)``), ``scale`` (per output
    channel, ``s_w``) and ``bias``, and the calibration buffers ``amax``
    and ``out_amax`` (None until calibrated). It takes NHWC input, float or
    :class:`QTensor`, and runs in ``dtype``; ``out_use`` (one of
    :data:`OUT_USES`) says which side of a calibrated output its consumers
    read. Its groups are 1, or depthwise (``groups == in_ch == out_ch``,
    stride 1)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, use_bn: bool = True, relu: bool = True,
                 groups: int = 1, bn_epsilon: float = 1e-3,
                 bn_decay: float = 0.99, quantized: bool = False,
                 out_use: str = "both", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.relu = relu
        self.quantized = quantized
        if not quantized:
            self.conv = Conv(in_ch, out_ch, kernel, stride,
                             use_bias=not use_bn, groups=groups)
            self.bn = (BatchRenorm(out_ch, bn_epsilon, bn_decay) if use_bn
                       else None)
            return
        self.depthwise = groups > 1
        if use_bn or (self.depthwise and not (
                groups == in_ch == out_ch and stride == 1)):
            raise NotImplementedError(
                "the int8 ConvBR takes folded (bias) convolutions, without "
                "groups or depthwise at stride 1")
        if out_use not in OUT_USES:
            raise ValueError(f"out_use must be one of {OUT_USES}")
        self.stride, self.out_use, self.dtype = stride, out_use, dtype
        self.calibrating = False
        self.register_buffer("kernel_q", torch.zeros(
            (kernel, kernel, in_ch // groups, out_ch), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_ch))
        self.register_buffer("bias", torch.zeros(out_ch))
        self.register_buffer("amax", None)
        self.register_buffer("out_amax", None)
        # kernel_q packed for its kernel: a buffer outside the state dict,
        # so that it moves with the module and an exported program holds it
        self.register_buffer("w_packed", None, persistent=False)
        self._w_key = None

    def forward(self, x, r_max=None, d_max=None):
        """``r_max``/``d_max``: the renorm clip schedule of a training
        forward (``models.hourglass.renorm_clip_schedule``)."""
        if self.quantized:
            return self._quantized_forward(x)
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, r_max, d_max)
        return F.relu(x) if self.relu else x

    def _packed_weight(self) -> torch.Tensor:
        """``kernel_q`` as its kernel's operand: K3's ``(N, k * k * Cp)``
        (``ops.int8_gemm.pack_weight``) or the depthwise kernel's
        ``(k * k, Cp)`` (``ops.int8_dwconv.pack_dw_weight``), made again
        whenever ``kernel_q`` moves or changes. Under ``torch.export`` (a
        traced tensor has no data pointer to key the cache by) the packed
        buffer is read as it stands, which :func:`pack_weights` refreshes
        first, so that the program holds it as a constant; without one the
        packing is traced into the program."""
        if torch.compiler.is_compiling():
            if self.w_packed is not None:
                return self.w_packed
            return (pack_dw_weight if self.depthwise
                    else pack_weight)(self.kernel_q)
        key = (self.kernel_q.data_ptr(), self.kernel_q._version)
        if self._w_key != key:
            pack = pack_dw_weight if self.depthwise else pack_weight
            self.w_packed, self._w_key = pack(self.kernel_q), key
        return self.w_packed

    def _conv(self, x_q, scale, **kw):
        """One kernel launch: the depthwise kernel, or K3's dense entry for
        a 1x1 stride-1 convolution and its implicit GEMM otherwise. Returns
        ``(q, f)``, NHWC."""
        k = self.kernel_q.shape[0]
        w = self._packed_weight()
        if self.depthwise:
            int8_counts["dw"] += 1
            return int8_dwconv_requant(x_q, w, k, scale, self.bias,
                                       relu=self.relu, **kw)
        if k > 1 or self.stride > 1:
            int8_counts["k3_implicit"] += 1
            return int8_conv_requant(x_q, w, k, self.stride, scale,
                                     self.bias, relu=self.relu, **kw)
        int8_counts["k3_dense"] += 1
        b, h, wd, c = x_q.shape
        out = int8_gemm_requant(x_q.reshape(b * h * wd, c), w[:, :c].t(),
                                scale, self.bias, relu=self.relu, **kw)
        return tuple(None if t is None else t.reshape(b, h, wd, -1)
                     for t in out)

    def _quantized_forward(self, x):
        if isinstance(x, QTensor):
            x_q, s_x = x.q, x.s
        else:
            int8_counts["quantize"] += 1
            with span("densereg.int8.quantize"):
                if self.calibrating:
                    s_x = act_scale(_record_amax(self, "amax", x))
                elif self.amax is not None:
                    s_x = act_scale(self.amax)
                else:
                    int8_counts["dynamic"] += 1
                    s_x = act_scale(x.float().abs().amax())
                x_q = quantize(x, s_x, pitch16=True)
        conv = lambda **kw: self._conv(x_q, s_x * self.scale, **kw)
        if self.calibrating:
            _, y = conv(emit_q=False, emit_f=True, f_dtype=torch.float32)
            return quantize_output(self, y, self.dtype)
        if self.out_amax is None:       # dynamic: the consumer quantizes
            return conv(emit_q=False, emit_f=True, f_dtype=self.dtype)[1]
        s_y = act_scale(self.out_amax)
        q, f = conv(s_y=s_y, emit_q=self.out_use != "f",
                    emit_f=self.out_use != "q", f_dtype=self.dtype)
        return QTensor(f, q, s_y)


class Residual(nn.Module):
    """Bottleneck residual: 1x1 (in/2) -> kxk (in/2) -> 1x1 (out), each
    conv + renorm + ReLU, plus the identity (or a 1x1 conv + renorm + ReLU
    projection when the width changes). The sum has no activation.
    ``separable`` (the ``um_v1_lite`` variant) makes the kxk convolution
    depthwise (``groups = in/2``)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 kernel_size: int = 3, use_bn: bool = True,
                 bn_epsilon: float = 1e-3, bn_decay: float = 0.99,
                 quantized: bool = False,
                 dtype: torch.dtype = torch.float32,
                 separable: bool = False):
        super().__init__()
        out_ch = in_ch if out_ch is None else out_ch
        half = in_ch // 2
        # int8: the inner convolutions feed convolutions, the last two the sum
        conv = lambda i, o, k, use, groups=1: ConvBR(
            i, o, k, use_bn=use_bn, groups=groups, bn_epsilon=bn_epsilon,
            bn_decay=bn_decay, quantized=quantized, out_use=use, dtype=dtype)
        self.conv1 = conv(in_ch, half, 1, "q")
        self.conv2 = conv(half, half, kernel_size, "q",
                          groups=half if separable else 1)
        self.conv3 = conv(half, out_ch, 1, "f")
        self.shortcut = (conv(in_ch, out_ch, 1, "f") if out_ch != in_ch
                         else None)
        self.quantized, self.dtype = quantized, dtype
        if quantized:
            self.calibrating = False
            self.register_buffer("out_amax", None)

    def forward(self, x, r_max=None, d_max=None):
        kw = dict(r_max=r_max, d_max=d_max)
        y = self.conv3(self.conv2(self.conv1(x, **kw), **kw), **kw)
        s = x if self.shortcut is None else self.shortcut(x, **kw)
        if not self.quantized:
            return y + s
        # calibrated graphs requantize the sum, so the next layer reads int8
        return quantize_output(self, as_float(y) + as_float(s), self.dtype)


def max_pool_same(x, window: int, stride: int, channels_last: bool = False):
    """Max pool with SAME padding (padded with -inf) on NCHW, or NHWC with
    ``channels_last``. Max pooling commutes with monotone quantization, so a
    :class:`QTensor` (NHWC) is pooled side by side with the same scale."""
    if isinstance(x, QTensor):
        pool = lambda t: None if t is None else max_pool_same(t, window,
                                                              stride, True)
        return QTensor(pool(x.f), pool(x.q), x.s)
    if channels_last:
        return _max_pool_nhwc(x, window, stride)
    ph = same_pads(x.shape[-2], window, stride)
    pw = same_pads(x.shape[-1], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def _max_pool_nhwc(x, window: int, stride: int):
    """The JAX package's form: an elementwise max over the window^2 strided
    slices of the padded tensor (int8 pads with -128)."""
    b, h, w, c = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    ph, pw = same_pads(h, window, stride), same_pads(w, window, stride)
    low = (float("-inf") if x.dtype.is_floating_point
           else torch.iinfo(x.dtype).min)
    xp = x.new_full((b, h + sum(ph), w + sum(pw), c), low)
    xp[:, ph[0]:ph[0] + h, pw[0]:pw[0] + w] = x
    out = None
    for i in range(window):
        for j in range(window):
            s = xp[:, i:i + (oh - 1) * stride + 1:stride,
                   j:j + (ow - 1) * stride + 1:stride]
            out = s if out is None else torch.maximum(out, s)
    return out


def upsample_nearest_2x(x, channels_last: bool = False):
    """Nearest x2 upsample on NCHW, or NHWC with ``channels_last`` (pure
    replication, so a :class:`QTensor` upsamples side by side)."""
    if isinstance(x, QTensor):
        up = lambda t: None if t is None else upsample_nearest_2x(t, True)
        return QTensor(up(x.f), up(x.q), x.s)
    if channels_last:
        b, h, w, c = x.shape
        return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
            b, 2 * h, 2 * w, c)
    return F.interpolate(x, scale_factor=2, mode="nearest")
