"""The lightweight hourglass ``um_v1_lite`` and its calibrated int8 form,
as plain functions over a flat weight dict.

``um_v1_lite`` is not the paper's net: it is the JAX package's own
depthwise-separable variant of ``um_v1`` at the paper's widths. Every
residual bottleneck's k x k convolution is depthwise (``groups`` = its
channels, kernels ``(C, 1, k, k)``); everything else is ``reference.net``'s
topology, paths and padding. Two float forms, as ``reference.net.Ctx``
names them: ``calibrate`` (the weight maker's unfolded pass,
``reference/lite_weights.py``) and ``eval`` (batch norm folded by
:func:`fold`, in any float dtype). The int8 form follows the JAX package's
post-training quantization (``models/quantize.py``, ``models/layers.py``):

* weights symmetric per output channel, ``s_w = max(max|k|, 1e-8) / 127``
  over each output channel's (in, h, w) (over (h, w) for a depthwise
  kernel), ``kernel_q = clip(round(k / s_w), -127, 127)``;
* activations per tensor, ``s = max(amax, 1e-8) / 127``: a convolution's
  float input with the convolution's own ``amax``, its output, a residual
  sum and an hourglass sum with their ``out_amax``; one calibrating pass
  over the calibration batch records each as the batch's ``max|x|`` and
  quantizes with it as it goes;
* a convolution's sums exact (a float64 product of the int8 values, exact
  while a sum stays under 2^53), then ``y = float32(acc) * (s_x * s_w)``,
  ``+ bias``, ReLU, each in float32 and rounded once; a consumer that is
  a convolution reads ``clip(round(y / s_y), -127, 127)`` of its
  producer's ``y`` and scale;
* concatenations, the masked branch, the residual and hourglass sums
  before their quantization, the inter-stack sum and the heads read the
  float32 results.

Departures from the JAX package, none of which moves a value: the layout
is NCHW; a quantized activation is carried as its float result and its
producer's scale, and each convolution that reads it quantizes it again
(the JAX package hands on the producer's int8 tensor: the same values,
since rounding is monotone and max pooling and nearest upsampling commute
with it); a 1x1 convolution is a matrix product, a k x k one a matrix
product of its unfolded patches and a depthwise one a sum over shifted
slices, all in float64 (no convolution library, which may pick transform
algorithms); only float32 views are written (the configuration's).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import net
from .decode import decode_xyz
from .preprocess import center_of_mass, crop_from_bbx, method2_resize, norm_dm

Tensors = Dict[str, torch.Tensor]


def depthwise(path: str) -> bool:
    """Whether the convolution at ``path`` is depthwise: a residual
    bottleneck's middle one."""
    return path.endswith("/conv2")


def conv_layers(cfg: dict):
    """Every convolution of the lite net in execution order, as ``(path,
    in_ch, out_ch, k, stride, out_h, out_w, bn, groups)``: ``net.conv_layers``
    with each residual's ``conv2`` depthwise."""
    out = []
    for path, i, o, k, s, oh, ow, bn in net.conv_layers(cfg):
        groups = i if depthwise(path) else 1
        out.append((path, i, o, k, s, oh, ow, bn, groups))
    return out


def param_shapes(cfg: dict):
    """``({path: shape} of the parameters, {path: shape} of the moving
    statistics)`` of the unfolded lite net, kernels OIHW."""
    params, stats = {}, {}
    for path, i, o, k, _, _, _, bn, groups in conv_layers(cfg):
        params[f"{path}/conv/kernel"] = (o, i // groups, k, k)
        if bn:
            params[f"{path}/bn/gamma"] = params[f"{path}/bn/beta"] = (o,)
            stats[f"{path}/bn/mean"] = stats[f"{path}/bn/var"] = (o,)
        else:
            params[f"{path}/conv/bias"] = (o,)
    return params, stats


def _pad(x, k: int, stride: int):
    """``x`` NCHW zero-padded as XLA's SAME pads it for a k x k window."""
    ph = net.same_pads(x.shape[-2], k, stride)
    pw = net.same_pads(x.shape[-1], k, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


class FloatForm:
    """The float forms over ``ctx`` (a ``reference.net.Ctx``, form
    ``calibrate`` or ``eval``): activations are NCHW tensors in the
    compute dtype."""

    def __init__(self, ctx: net.Ctx):
        self.ctx = ctx

    def input(self, dms):
        return dms.permute(0, 3, 1, 2).to(self.ctx.dtype)

    def conv(self, path, x, stride=1, bn=True, relu=True):
        ctx = self.ctx
        kernel = ctx.p[f"{path}/conv/kernel"].to(x.dtype)
        groups = x.shape[1] // kernel.shape[1]
        use_bn = bn and ctx.form != "eval"
        bias = None if use_bn else ctx.p[f"{path}/conv/bias"].to(x.dtype)
        y = F.conv2d(_pad(x, kernel.shape[-1], stride), kernel, bias,
                     stride, groups=groups)
        if use_bn:
            y = net._renorm(ctx, path, y)
        elif ctx.hook is not None:
            y = ctx.hook(path, x, y)
        return F.relu(y) if relu else y

    def requant(self, path, x):
        return x

    def view(self, x):
        return x

    def pool(self, x, window, stride):
        return net.max_pool_same(x, window, stride)

    def up(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class Act:
    """A quantized activation of the int8 form: its producer's float32
    result ``f`` (NCHW) and the producer's scale ``s`` (a 0-d float32
    tensor)."""

    __slots__ = ("f", "s")

    def __init__(self, f, s):
        self.f, self.s = f, s


class Int8Form:
    """The calibrated int8 form. ``qparams`` from :func:`quantize_weights`;
    ``stats`` the activation maxima ``{"<path>/amax" | "<path>/out_amax":
    0-d float32}``, recorded into while ``calibrating``. ``levels`` is the
    largest int8 step of an activation, 127; a control of lower precision
    passes 63 (a 7-bit activation)."""

    def __init__(self, qparams: Tensors, stats: Tensors,
                 calibrating: bool = False, levels: int = 127):
        self.p, self.stats = qparams, stats
        self.calibrating, self.levels = calibrating, levels
        # the forward's steps as the JAX package takes them: convolutions
        # by kind, and standalone quantizations, of a float input or of a
        # sum (a convolution's quantization of its producer's result here
        # stands for the producer's epilogue, and is none)
        self.steps = dict.fromkeys(("k3_dense", "k3_implicit", "dw",
                                    "quantize"), 0)

    def _scale(self, key, x):
        """``max(amax, 1e-8) / levels``, ``amax`` the recorded one, or the
        batch's own while calibrating (kept as a running max)."""
        if self.calibrating:
            amax = x.abs().amax()
            old = self.stats.get(key)
            self.stats[key] = amax if old is None else torch.maximum(old,
                                                                     amax)
        else:
            amax = self.stats[key]
        amax = torch.clamp_min(amax.float(), 1e-8)
        return amax / amax.new_full((), float(self.levels))

    def _quant(self, x, s):
        return torch.clamp(torch.round(x / s), -self.levels, self.levels)

    def input(self, dms):
        return dms.permute(0, 3, 1, 2).float()

    def conv(self, path, x, stride=1, bn=True, relu=True):
        if isinstance(x, Act):
            s_x, xf = x.s, x.f
        else:
            xf = x
            s_x = self._scale(f"{path}/amax", xf)
            self.steps["quantize"] += 1
        x_q = self._quant(xf, s_x).double()
        k_q = self.p[f"{path}/kernel_q"].double()
        k = k_q.shape[-1]
        kind = ("dw" if depthwise(path) else
                "k3_dense" if k == 1 and stride == 1 else "k3_implicit")
        self.steps[kind] += 1
        if kind == "dw":
            xp = _pad(x_q, k, 1)
            h, w = x_q.shape[-2:]
            acc = sum(xp[:, :, i:i + h, j:j + w]
                      * k_q[:, 0, i, j].view(1, -1, 1, 1)
                      for i in range(k) for j in range(k))
        elif kind == "k3_dense":
            b, c, h, w = x_q.shape
            acc = (x_q.permute(0, 2, 3, 1).reshape(-1, c)
                   @ k_q[:, :, 0, 0].t())
            acc = acc.view(b, h, w, -1).permute(0, 3, 1, 2)
        else:
            xp = _pad(x_q, k, stride)
            oh, ow = -(-x_q.shape[-2] // stride), -(-x_q.shape[-1] // stride)
            cols = F.unfold(xp, k, stride=stride)            # (b, c k k, L)
            acc = k_q.reshape(k_q.shape[0], -1) @ cols
            acc = acc.view(x_q.shape[0], -1, oh, ow)
        scale = s_x * self.p[f"{path}/scale"]
        y = acc.float() * scale.view(1, -1, 1, 1)
        y = y + self.p[f"{path}/bias"].view(1, -1, 1, 1)
        if relu:
            y = torch.clamp_min(y, 0.0)
        return self._tagged(path, y)      # the epilogue's quantization

    def _tagged(self, path, x):
        """``x`` with the scale of its producer at ``path``."""
        xf = self.view(x)
        return Act(xf, self._scale(f"{path}/out_amax", xf))

    def requant(self, path, x):
        """A sum's quantization, a standalone step."""
        self.steps["quantize"] += 1
        return self._tagged(path, x)

    def view(self, x):
        return x.f if isinstance(x, Act) else x

    def pool(self, x, window, stride):
        if not isinstance(x, Act):
            return net.max_pool_same(x, window, stride)
        return Act(net.max_pool_same(x.f, window, stride), x.s)

    def up(self, x):
        return Act(F.interpolate(x.f, scale_factor=2, mode="nearest"), x.s)


def residual(form, path: str, x, in_ch: int, out_ch: int):
    y = form.conv(f"{path}/conv1", x)
    y = form.conv(f"{path}/conv2", y)
    y = form.conv(f"{path}/conv3", y)
    s = x if out_ch == in_ch else form.conv(f"{path}/shortcut", x)
    return form.requant(path, form.view(y) + form.view(s))


def hourglass(form, path: str, x, depth: int, ch: int, k: int):
    upper = residual(form, f"{path}/upper", x, ch, ch)
    lower = residual(form, f"{path}/lower_in", form.pool(x, k, 2), ch, ch)
    if depth > 1:
        lower = hourglass(form, f"{path}/inner", lower, depth - 1, ch, k)
    lower = residual(form, f"{path}/lower_out", lower, ch, ch)
    return form.requant(path, form.view(upper) + form.view(form.up(lower)))


def forward(form, cfg: dict, dms: torch.Tensor) -> Dict[str, List]:
    """Normalized depth ``(b, H, W, 1)`` -> ``{"hm", "hm3", "um"}``, one
    float32 NHWC tensor a stack, ``(b, H/4, W/4, J | J | 3J)``."""
    f, j = cfg["num_fea"], cfg["num_joint"]
    x = form.input(dms)
    b = x.shape[0]
    v = form.view
    cat = lambda ts: torch.cat([v(t) for t in ts], dim=1)
    y = residual(form, "stem_res1", form.conv("stem_conv", x, stride=2),
                 32, 64)
    y = form.pool(y, 2, 2)
    hg_in = residual(form, "stem_res3",
                     residual(form, "stem_res2", y, 64, 64), 64, f)
    out_h, out_w = x.shape[2] // 4, x.shape[3] // 4
    tiny = x[:, :, ::4, ::4]
    uu = torch.arange(out_w, dtype=x.dtype, device=x.device) / (out_w / 2) - 1.0
    vv = torch.arange(out_h, dtype=x.dtype, device=x.device) / (out_h / 2) - 1.0
    uvd = torch.cat([uu.view(1, 1, 1, out_w).expand(b, 1, out_h, out_w),
                     vv.view(1, 1, out_h, 1).expand(b, 1, out_h, out_w),
                     tiny], dim=1)
    invalid = tiny < -0.9
    depth = net.HOURGLASS_DEPTH[dms.shape[1]]
    outs = {"hm": [], "hm3": [], "um": []}
    for i in range(cfg["num_stack"]):
        n = lambda name: f"{name}_s{i}"
        hg = hourglass(form, n("hg"), hg_in, depth, f, cfg["kernel_size"])
        ll = form.conv(n("ll_conv"), residual(form, n("ll_res"), hg, f, f))
        hm = v(form.conv(n("hm_head"), ll, bn=False, relu=False))
        hm3 = v(form.conv(n("hm3_head"),
                          residual(form, n("hm3_res"), cat([ll, uvd]),
                                   f + 3, 128), bn=False, relu=False))
        um_cat = cat([hg, hm, hm3])
        um_in = residual(form, n("um_resB"),
                         residual(form, n("um_resA"), um_cat, f + 2 * j, 256),
                         256, 256)
        um_mask = torch.where(invalid, torch.zeros_like(um_cat), um_cat)
        um_mask = residual(form, n("umm_resB"),
                           residual(form, n("umm_resA"), um_mask, f + 2 * j,
                                    256), 256, 256)
        comb = cat([residual(form, n("um_comb"), cat([um_in, um_mask]),
                             512, 512), uvd])
        um = form.conv(n("um_fc1"), comb, bn=False)
        um = form.conv(n("um_fc2"), um, bn=False)
        um = v(form.conv(n("um_head"), um, bn=False, relu=False))
        for key, t in (("hm", hm), ("hm3", hm3), ("um", um)):
            outs[key].append(t.float().permute(0, 2, 3, 1))
        if i < cfg["num_stack"] - 1:
            tmp = v(form.conv(n("inter_out"), cat([hm, hm3, um]), bn=False,
                              relu=False))
            hg_in = (v(hg_in) + tmp
                     + v(form.conv(n("inter_ll"), ll, bn=False, relu=False)))
    return outs


def fold(params: Tensors, stats: Tensors, eps: float = 1e-3) -> Tensors:
    """``net.fold`` on the CPU with a correctly rounded square root (the
    float64 one, rounded to float32): ``torch.sqrt`` of float32 on the
    CPU is not always, and an int8 weight scale takes its last bit."""
    cpu = lambda t: {k: v.detach().float().cpu() for k, v in t.items()}
    params, stats = cpu(params), cpu(stats)
    out = {k: v for k, v in params.items() if "/bn/" not in k}
    for key in params:
        if not key.endswith("/bn/gamma"):
            continue
        path = key[:-len("/bn/gamma")]
        var = stats[f"{path}/bn/var"] + torch.tensor(eps, dtype=torch.float32)
        s = params[key] / torch.sqrt(var.double()).float()
        out[f"{path}/conv/kernel"] = (params[f"{path}/conv/kernel"]
                                      * s.view(-1, 1, 1, 1))
        out[f"{path}/conv/bias"] = (params[f"{path}/bn/beta"]
                                    - stats[f"{path}/bn/mean"] * s)
    return out


def quantize_weights(folded: Tensors) -> Tensors:
    """A folded weight dict (:func:`fold`) -> ``{"<path>/kernel_q" (OIHW,
    the int8 values as float32), "<path>/scale" (s_w), "<path>/bias"}``,
    computed on the CPU in float32."""
    out = {}
    for key, k in folded.items():
        if not key.endswith("/conv/kernel"):
            continue
        path = key[:-len("/conv/kernel")]
        k = k.detach().float().cpu()
        s_w = (torch.clamp_min(k.abs().amax(dim=(1, 2, 3)),
                               torch.tensor(1e-8))
               / torch.tensor(127.0))
        out[f"{path}/kernel_q"] = torch.clamp(
            torch.round(k / s_w.view(-1, 1, 1, 1)), -127, 127)
        out[f"{path}/scale"] = s_w
        out[f"{path}/bias"] = folded[f"{path}/conv/bias"].detach().float(
            ).cpu()
    return out


@torch.no_grad()
def calibrate(cfg: dict, qparams: Tensors, normed: torch.Tensor,
              levels: int = 127) -> Tensors:
    """The activation maxima of one calibrating pass over ``normed``
    ``(b, H, W, 1)``, the whole calibration batch at once, as the
    program's predictor takes it."""
    stats: Tensors = {}
    forward(Int8Form(qparams, stats, calibrating=True, levels=levels), cfg,
            normed)
    return stats


def int8_forward(qparams: Tensors, stats: Tensors,
                 levels: int = 127) -> Callable:
    """The calibrated int8 net as a function of normalized depth."""
    return lambda cfg, dms: forward(Int8Form(qparams, stats, levels=levels),
                                    cfg, dms)


def float_forward(folded: Tensors, dtype: torch.dtype) -> Callable:
    """The folded float net in ``dtype`` as a function of normalized
    depth."""
    return lambda cfg, dms: forward(FloatForm(net.Ctx(folded, "eval",
                                                      dtype)), cfg, dms)


def on_device(t: Tensors, device) -> Tensors:
    return {k: v.to(device) for k, v in t.items()}


@torch.no_grad()
def predict(cfg: dict, fwd: Callable, frames: np.ndarray, boxes: np.ndarray,
            cam: torch.Tensor, block: int = 256) -> np.ndarray:
    """``reference.serving.predict`` with the lite net ``fwd`` (from
    :func:`int8_forward` or :func:`float_forward`, its weights on ``cam``'s
    device): joints ``(n, 3j)`` float32, in blocks of ``block`` rows, with
    TF32 off."""
    dev = cam.device
    size = cfg["input_size"]
    out = []
    with net.tf32_switch(False):
        for s in range(0, len(frames), block):
            dms = torch.from_numpy(np.ascontiguousarray(
                frames[s:s + block])).to(dev)
            bbx = torch.from_numpy(np.asarray(boxes[s:s + block],
                                              np.float32)).to(dev)
            crops, cfgs = crop_from_bbx(dms, bbx, cam, size, size)
            coms = center_of_mass(crops, cfgs)
            normed = norm_dm(crops, coms)
            heads = fwd(cfg, normed)
            tiny = method2_resize(normed, size // 4, size // 4)
            out.append(decode_xyz(heads["hm"][-1], heads["hm3"][-1],
                                  heads["um"][-1], tiny, cfgs, coms)
                       .cpu().numpy())
    return np.concatenate(out)


def amax_gap_rel(got: Dict[str, Optional[float]], want: Tensors) -> float:
    """The worst relative gap of a calibrated net's activation maxima
    ``got`` (by the same keys; None or missing where it recorded none)
    from ``want``: ``|got - want| / want``, 1e9 for a missing one."""
    worst = 0.0
    for key, w in want.items():
        g = got.get(key)
        w = float(w)
        if g is None or not np.isfinite(g):
            return 1e9
        worst = max(worst, abs(g - w) / max(w, 1e-8))
    return worst

