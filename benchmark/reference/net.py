"""The stacked-hourglass net ``um_v1`` as plain functions over a flat
weight dict, in three forms:

* ``eval``: batch norm folded into the convolutions (the serving form),
  every convolution in the compute dtype, heads returned in float32;
* ``train``: batch renorm on the batch moments with the r/d clip of the
  moving statistics, which then move once; dropout after the ReLUs of
  ``um_fc1`` and ``um_fc2``;
* ``calibrate``: the unfolded eval form in float32 that sets each renorm's
  moving statistics to the moments it sees and scales each convolution
  without renorm (the weight maker's pass, ``benchmark/weights.py``).

Weights are keyed by their Flax path (``stem_res1/conv1/conv/kernel``,
moving statistics ``.../bn/mean``), kernels OIHW. Layout NCHW inside;
normalized depth ``(b, H, W, 1)`` in, per-stack lists of NHWC float32 heads
out. Padding is XLA's SAME, uneven for a stride-2 window on an even input.
The order of every random draw (dropout masks) follows the net's
execution order, stack by stack.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

HOURGLASS_DEPTH = {32: 2, 64: 3, 128: 4, 256: 5, 512: 6}


def same_pads(size: int, window: int, stride: int):
    """(before, after) padding of XLA's SAME for one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def renorm_clip_schedule(t: torch.Tensor):
    """``r_max = 3 / (1 + 2 e^-t)``, ``d_max = 1e-3 e^{2t}``, in float32."""
    t = torch.as_tensor(t, dtype=torch.float32).cpu()
    return (float(3.0 / (1.0 + 2.0 * torch.exp(-t))),
            float(1e-3 * torch.exp(2.0 * t)))


@contextlib.contextmanager
def tf32_switch(on: bool):
    """cuDNN's and cuBLAS's TF32 for float32 set to ``on`` for the block,
    then put back: off is float32 as the configuration states it, whatever
    the process's default (cuDNN's is on)."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class _RoundTF32(torch.autograd.Function):
    """float32 rounded to TF32's 10-bit mantissa, to nearest (ties away
    from zero), with the gradient passed straight through."""

    @staticmethod
    def forward(ctx, x):
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    @staticmethod
    def backward(ctx, g):
        return g


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a TF32 tensor core reads it (float32 operands only)."""
    return _RoundTF32.apply(x) if x.dtype == torch.float32 else x


class Ctx:
    """What one forward reads: the weights, the form, the compute dtype,
    the renorm clip and the generator of the dropout masks. ``hook``, in
    the calibrate form, is called as ``hook(path, x, conv_out)`` at each
    convolution without renorm before its output is used.
    ``round_operands``, where given, rounds each convolution's input and
    kernel first (a control in a lower precision, e.g. :func:`tf32`)."""

    def __init__(self, params: Dict[str, torch.Tensor], form: str,
                 dtype: torch.dtype = torch.float32,
                 stats: Optional[Dict[str, torch.Tensor]] = None,
                 r_max: Optional[float] = None, d_max: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 dropout_rate: float = 0.5, bn_epsilon: float = 1e-3,
                 bn_decay: float = 0.99, hook: Optional[Callable] = None,
                 round_operands: Optional[Callable] = None):
        if form not in ("eval", "train", "calibrate"):
            raise ValueError(f"unknown form {form!r}")
        self.p, self.s, self.form, self.dtype = params, stats, form, dtype
        self.r_max, self.d_max, self.generator = r_max, d_max, generator
        self.rate, self.eps, self.decay = dropout_rate, bn_epsilon, bn_decay
        self.hook = hook
        self.round = round_operands


def _conv(ctx: Ctx, path: str, x, stride: int = 1, bias: bool = True):
    kernel = ctx.p[f"{path}/conv/kernel"].to(x.dtype)
    b = ctx.p[f"{path}/conv/bias"].to(x.dtype) if bias else None
    if ctx.round is not None:
        x, kernel = ctx.round(x), ctx.round(kernel)
    k = kernel.shape[-1]
    ph = same_pads(x.shape[-2], k, stride)
    pw = same_pads(x.shape[-1], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, kernel, b, stride, (ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), kernel, b,
                    stride)


def _renorm(ctx: Ctx, path: str, x):
    """Batch renorm of the train and calibrate forms, in float32."""
    view = lambda t: t.float().view(1, -1, 1, 1)
    g, bt = ctx.p[f"{path}/bn/gamma"], ctx.p[f"{path}/bn/beta"]
    mean_key, var_key = f"{path}/bn/mean", f"{path}/bn/var"
    xf = x.float()
    if ctx.form == "calibrate":
        xd = xf.double()
        var = xd.var(dim=(0, 2, 3), unbiased=False)
        ctx.s[mean_key] = xd.mean(dim=(0, 2, 3)).float()
        ctx.s[var_key] = (var + 0.1 * var.mean() + 1e-4).float()
        y = (xf - view(ctx.s[mean_key])) / torch.sqrt(view(ctx.s[var_key])
                                                      + ctx.eps)
        return (y * view(g) + view(bt)).to(x.dtype)
    mean = xf.mean(dim=(0, 2, 3))
    var = torch.square(xf - mean.view(1, -1, 1, 1)).mean(dim=(0, 2, 3))
    std = torch.sqrt(var + ctx.eps)
    y = (xf - view(mean)) / view(std)
    mov_mean, mov_var = ctx.s[mean_key], ctx.s[var_key]
    if ctx.r_max is not None:
        with torch.no_grad():
            mov_std = torch.sqrt(mov_var + ctx.eps)
            r = torch.clamp(std / mov_std, 1.0 / ctx.r_max, ctx.r_max)
            d = torch.clamp((mean - mov_mean) / mov_std, -ctx.d_max,
                            ctx.d_max)
        y = y * view(r) + view(d)
    with torch.no_grad():
        ctx.s[mean_key] = ctx.decay * mov_mean + (1.0 - ctx.decay) * mean
        ctx.s[var_key] = ctx.decay * mov_var + (1.0 - ctx.decay) * var
    return (y * view(g) + view(bt)).to(x.dtype)


def conv_br(ctx: Ctx, path: str, x, stride: int = 1, bn: bool = True,
            relu: bool = True):
    """conv -> [renorm | bias] -> [ReLU]; a folded net's renorm is the
    bias."""
    if bn and ctx.form != "eval":
        y = _renorm(ctx, path, _conv(ctx, path, x, stride, bias=False))
    else:
        y = _conv(ctx, path, x, stride)
        if ctx.hook is not None:
            y = ctx.hook(path, x, y)
    return F.relu(y) if relu else y


def residual(ctx: Ctx, path: str, x, in_ch: int, out_ch: int):
    y = conv_br(ctx, f"{path}/conv1", x)
    y = conv_br(ctx, f"{path}/conv2", y)
    y = conv_br(ctx, f"{path}/conv3", y)
    s = x if out_ch == in_ch else conv_br(ctx, f"{path}/shortcut", x)
    return y + s


def max_pool_same(x, window: int, stride: int):
    ph = same_pads(x.shape[-2], window, stride)
    pw = same_pads(x.shape[-1], window, stride)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def hourglass(ctx: Ctx, path: str, x, depth: int, ch: int):
    upper = residual(ctx, f"{path}/upper", x, ch, ch)
    lower = residual(ctx, f"{path}/lower_in", max_pool_same(x, 3, 2), ch, ch)
    if depth > 1:
        lower = hourglass(ctx, f"{path}/inner", lower, depth - 1, ch)
    lower = residual(ctx, f"{path}/lower_out", lower, ch, ch)
    return upper + F.interpolate(lower, scale_factor=2, mode="nearest")


def dropout(ctx: Ctx, x):
    if ctx.form != "train" or ctx.rate == 0.0:
        return x
    keep = 1.0 - ctx.rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=ctx.generator)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def forward(ctx: Ctx, cfg: dict, dms: torch.Tensor) -> Dict[str, List]:
    """Normalized depth ``(b, H, W, 1)`` -> ``{"hm", "hm3", "um"}``, one
    float32 NHWC tensor a stack, ``(b, H/4, W/4, J | J | 3J)``."""
    f, j = cfg["num_fea"], cfg["num_joint"]
    x = dms.permute(0, 3, 1, 2).to(ctx.dtype)
    b = x.shape[0]
    y = residual(ctx, "stem_res1", conv_br(ctx, "stem_conv", x, stride=2),
                 32, 64)
    y = max_pool_same(y, 2, 2)
    hg_in = residual(ctx, "stem_res3", residual(ctx, "stem_res2", y, 64, 64),
                     64, f)
    out_h, out_w = x.shape[2] // 4, x.shape[3] // 4
    tiny = x[:, :, ::4, ::4]
    uu = torch.arange(out_w, dtype=ctx.dtype, device=x.device) / (out_w / 2) - 1.0
    vv = torch.arange(out_h, dtype=ctx.dtype, device=x.device) / (out_h / 2) - 1.0
    uvd = torch.cat([uu.view(1, 1, 1, out_w).expand(b, 1, out_h, out_w),
                     vv.view(1, 1, out_h, 1).expand(b, 1, out_h, out_w),
                     tiny], dim=1)
    invalid = tiny < -0.9
    depth = HOURGLASS_DEPTH[dms.shape[1]]
    outs = {"hm": [], "hm3": [], "um": []}
    for i in range(cfg["num_stack"]):
        n = lambda name: f"{name}_s{i}"
        hg = hourglass(ctx, n("hg"), hg_in, depth, f)
        ll = conv_br(ctx, n("ll_conv"), residual(ctx, n("ll_res"), hg, f, f),
                     bn=True)
        hm = conv_br(ctx, n("hm_head"), ll, bn=False, relu=False)
        hm3 = conv_br(ctx, n("hm3_head"),
                      residual(ctx, n("hm3_res"), torch.cat([ll, uvd], 1),
                               f + 3, 128), bn=False, relu=False)
        um_cat = torch.cat([hg, hm, hm3], dim=1)
        um_in = residual(ctx, n("um_resB"),
                         residual(ctx, n("um_resA"), um_cat, f + 2 * j, 256),
                         256, 256)
        um_mask = torch.where(invalid, torch.zeros_like(um_cat), um_cat)
        um_mask = residual(ctx, n("umm_resB"),
                           residual(ctx, n("umm_resA"), um_mask, f + 2 * j,
                                    256), 256, 256)
        comb = residual(ctx, n("um_comb"), torch.cat([um_in, um_mask], 1),
                        512, 512)
        comb = torch.cat([comb, uvd], dim=1)
        um = dropout(ctx, conv_br(ctx, n("um_fc1"), comb, bn=False))
        um = dropout(ctx, conv_br(ctx, n("um_fc2"), um, bn=False))
        um = conv_br(ctx, n("um_head"), um, bn=False, relu=False)
        for key, v in (("hm", hm), ("hm3", hm3), ("um", um)):
            outs[key].append(v.float().permute(0, 2, 3, 1))
        if i < cfg["num_stack"] - 1:
            tmp = conv_br(ctx, n("inter_out"), torch.cat([hm, hm3, um], 1),
                          bn=False, relu=False)
            hg_in = hg_in + tmp + conv_br(ctx, n("inter_ll"), ll, bn=False,
                                          relu=False)
    return outs


def fold(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
         eps: float = 1e-3) -> Dict[str, torch.Tensor]:
    """Fold each eval-form renorm into its convolution, in float32:
    ``kernel * s`` and ``beta - mean * s``, ``s = gamma / sqrt(var + eps)``
    per output channel."""
    out = {k: v for k, v in params.items() if "/bn/" not in k}
    for key in params:
        if not key.endswith("/bn/gamma"):
            continue
        path = key[:-len("/bn/gamma")]
        s = params[key] / torch.sqrt(stats[f"{path}/bn/var"] + eps)
        out[f"{path}/conv/kernel"] = (params[f"{path}/conv/kernel"]
                                      * s.view(-1, 1, 1, 1))
        out[f"{path}/conv/bias"] = (params[f"{path}/bn/beta"]
                                    - stats[f"{path}/bn/mean"] * s)
    return out


def conv_layers(cfg: dict):
    """Every convolution of the net in execution order, as ``(path, in_ch,
    out_ch, k, stride, out_h, out_w, bn)``, from the configuration's sizes
    alone (``num_stack``, ``num_fea``, ``num_joint``, ``input_size``)."""
    f, j, size = cfg["num_fea"], cfg["num_joint"], cfg["input_size"]
    layers = []

    def conv(path, i, o, k, s, hw, bn=True):
        layers.append((path, i, o, k, 1 if s is None else s, hw, hw, bn))

    def res(path, i, o, hw):
        conv(f"{path}/conv1", i, i // 2, 1, 1, hw)
        conv(f"{path}/conv2", i // 2, i // 2, 3, 1, hw)
        conv(f"{path}/conv3", i // 2, o, 1, 1, hw)
        if i != o:
            conv(f"{path}/shortcut", i, o, 1, 1, hw)

    def hg(path, depth, hw):
        res(f"{path}/upper", f, f, hw)
        res(f"{path}/lower_in", f, f, hw // 2)
        if depth > 1:
            hg(f"{path}/inner", depth - 1, hw // 2)
        res(f"{path}/lower_out", f, f, hw // 2)

    conv("stem_conv", 1, 32, 7, 2, size // 2)
    res("stem_res1", 32, 64, size // 2)
    res("stem_res2", 64, 64, size // 4)
    res("stem_res3", 64, f, size // 4)
    s = size // 4
    for i in range(cfg["num_stack"]):
        hg(f"hg_s{i}", HOURGLASS_DEPTH[size], s)
        res(f"ll_res_s{i}", f, f, s)
        conv(f"ll_conv_s{i}", f, f, 1, 1, s)
        conv(f"hm_head_s{i}", f, j, 1, 1, s, bn=False)
        res(f"hm3_res_s{i}", f + 3, 128, s)
        conv(f"hm3_head_s{i}", 128, j, 1, 1, s, bn=False)
        res(f"um_resA_s{i}", f + 2 * j, 256, s)
        res(f"um_resB_s{i}", 256, 256, s)
        res(f"umm_resA_s{i}", f + 2 * j, 256, s)
        res(f"umm_resB_s{i}", 256, 256, s)
        res(f"um_comb_s{i}", 512, 512, s)
        conv(f"um_fc1_s{i}", 515, 512, 1, 1, s, bn=False)
        conv(f"um_fc2_s{i}", 512, 512, 1, 1, s, bn=False)
        conv(f"um_head_s{i}", 512, 3 * j, 1, 1, s, bn=False)
        if i < cfg["num_stack"] - 1:
            conv(f"inter_out_s{i}", 5 * j, f, 1, 1, s, bn=False)
            conv(f"inter_ll_s{i}", f, f, 1, 1, s, bn=False)
    return layers


def param_shapes(cfg: dict):
    """``({path: shape} of the parameters, {path: shape} of the moving
    statistics)`` of the unfolded net, kernels OIHW."""
    params, stats = {}, {}
    for path, i, o, k, _, _, _, bn in conv_layers(cfg):
        params[f"{path}/conv/kernel"] = (o, i, k, k)
        if bn:
            params[f"{path}/bn/gamma"] = params[f"{path}/bn/beta"] = (o,)
            stats[f"{path}/bn/mean"] = stats[f"{path}/bn/var"] = (o,)
        else:
            params[f"{path}/conv/bias"] = (o,)
    return params, stats
