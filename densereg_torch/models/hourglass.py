"""Stacked-hourglass dense-regression network, training and eval form, in
its three variants (``NetConfig.net_module``): ``um_v1``; ``um_v1_lite``,
whose residual bottlenecks take a depthwise middle convolution; and
``um_v1_deconv``, whose hourglass upsamples with a learned stride-2
transposed convolution (``models.ops.Deconv``) instead of nearest.

Mirrors ``densereg_tpu/models/hourglass.py`` module for module, with the
same submodule names. Inside, the layout is NCHW; the public interface keeps
the JAX package's: normalized depth ``(b, H, W, 1)`` in, per-stack lists of
NHWC float32 heads out. Channel concatenations follow the NHWC order of the
JAX net. ``module.training`` selects the form: batch renorm on batch
moments and dropout in training, the moving statistics in eval.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from densereg_torch.config import NetConfig
from densereg_torch.models.layers import (
    ConvBR,
    Residual,
    as_float,
    max_pool_same,
    quantize_output,
    upsample_nearest_2x,
)
from densereg_torch.models.ops import Deconv, dropout

def refuse_calibrated_deconv(cfg: NetConfig) -> None:
    """Raise ``NotImplementedError`` for a ``um_v1_deconv`` net that is
    about to be calibrated or given calibration statistics: the JAX
    package's calibrated int8 net of that variant crashes when its
    transposed convolution meets a QTensor, and the port adds no form of
    it."""
    if cfg.net_module == "um_v1_deconv":
        raise NotImplementedError(
            "a calibrated int8 um_v1_deconv is not supported: the JAX "
            "package's net crashes on it (densereg_tpu/models/hourglass.py:93 "
            "hands the ConvTranspose a QTensor); serve um_v1_deconv in float "
            "or dynamic int8")


def renorm_clip_schedule(t) -> Tuple[float, float]:
    """The r/d clip schedule of batch renorm as a function of the schedule
    clock ``t`` (advanced by ``NetConfig.renorm_t_delta`` a micro step),
    evaluated in float32 as the JAX package does:

        r_max = 3 / (1 + 2 e^{-t})          (1 -> 3)
        d_max = 1e-3 * e^{2t}
    """
    t = torch.as_tensor(t, dtype=torch.float32).cpu()
    r_max = 3.0 / (1.0 + 2.0 * torch.exp(-t))
    d_max = 1e-3 * torch.exp(2.0 * t)
    return float(r_max), float(d_max)


class Hourglass(nn.Module):
    """Recursive hourglass: ``upper = res(x)``; ``lower = res(pool3x3/2(x))``
    -> recurse -> ``res`` -> nearest x2 upsample, or with ``deconv_up`` a
    learned stride-2 transposed convolution (``deconv_up``, float in every
    form); sum (requantized in a calibrated int8 graph)."""

    def __init__(self, depth: int, ch: int, kernel_size: int = 3,
                 use_bn: bool = True, bn_epsilon: float = 1e-3,
                 bn_decay: float = 0.99, quantized: bool = False,
                 dtype: torch.dtype = torch.float32, separable: bool = False,
                 deconv_up: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        self.quantized, self.dtype = quantized, dtype
        res = lambda: Residual(ch, kernel_size=kernel_size, use_bn=use_bn,
                               bn_epsilon=bn_epsilon, bn_decay=bn_decay,
                               quantized=quantized, dtype=dtype,
                               separable=separable)
        self.upper = res()
        self.lower_in = res()
        self.inner = (Hourglass(depth - 1, ch, kernel_size, use_bn,
                                bn_epsilon, bn_decay, quantized, dtype,
                                separable, deconv_up)
                      if depth > 1 else None)
        self.lower_out = res()
        self.deconv_up = (Deconv(ch, ch, kernel_size, 2, relu=False)
                          if deconv_up else None)
        if quantized:
            self.calibrating = False
            self.register_buffer("out_amax", None)

    def forward(self, x, r_max=None, d_max=None):
        q = self.quantized           # int8 runs NHWC
        kw = dict(r_max=r_max, d_max=d_max)
        upper = self.upper(x, **kw)
        lower = self.lower_in(max_pool_same(x, self.kernel_size, 2, q), **kw)
        if self.inner is not None:
            lower = self.inner(lower, **kw)
        lower = self.lower_out(lower, **kw)
        if self.deconv_up is None:
            up = upsample_nearest_2x(lower, q)
        else:                        # dynamic int8 too: float, as in JAX
            up = self.deconv_up(lower, channels_last=q)
        if not q:
            return upper + up
        return quantize_output(self, as_float(upper) + as_float(up),
                               self.dtype)


class DenseRegNet(nn.Module):
    """The detector, in the variant ``cfg.net_module`` names (one of
    :data:`NET_MODULES`). ``forward(dms)`` takes normalized depth
    ``(b, H, W, 1)`` and returns ``{"hm": [...], "hm3": [...], "um": [...]}``,
    one float32 NHWC tensor per stack, ``(b, H/4, W/4, J | J | 3J)``.

    Weights stay float32; every convolution runs in
    ``cfg.compute_dtype``. In training mode (``net.train()``) batch renorm
    takes the clip schedule ``r_max``/``d_max`` and dropout draws its masks
    from ``generator``."""

    def __init__(self, cfg: NetConfig):
        super().__init__()
        if cfg.quantize and not cfg.fold_bn:
            raise ValueError("an int8 net is a folded one: set fold_bn "
                             "(models.quantize.quantized_net_config)")
        self.cfg = cfg
        f, j = cfg.num_fea, cfg.num_joint
        bn = dict(use_bn=not cfg.fold_bn, bn_epsilon=cfg.bn_epsilon,
                  bn_decay=cfg.bn_decay)
        if cfg.quantize:
            bn.update(quantized=True, dtype=cfg.torch_dtype)
        def conv(in_ch, out_ch, k, use, **kw):
            """``use``: what a calibrated int8 output's consumers read."""
            kw = {**bn, **kw}
            if cfg.quantize:
                kw["out_use"] = use
            return ConvBR(in_ch, out_ch, k, **kw)

        separable = cfg.net_module == "um_v1_lite"
        deconv_up = cfg.net_module == "um_v1_deconv"

        def res(in_ch, out_ch=None):
            return Residual(in_ch, out_ch, cfg.kernel_size, separable=separable,
                            **bn)

        def head(in_ch, out_ch):
            return conv(in_ch, out_ch, 1, "f", use_bn=False, relu=False)

        self.stem_conv = conv(1, 32, 7, "q", stride=2)
        self.stem_res1 = res(32, 64)
        self.stem_res2 = res(64)
        self.stem_res3 = res(64, f)
        for i in range(cfg.num_stack):
            s = f"_s{i}"
            layers = {
                "hg": Hourglass(cfg.hourglass_depth, f, cfg.kernel_size,
                                separable=separable, deconv_up=deconv_up,
                                **bn),
                "ll_res": res(f),
                "ll_conv": conv(f, f, 1, "both"),
                "hm_head": head(f, j),
                "hm3_res": res(f + 3, 128),
                "hm3_head": head(128, j),
                "um_resA": res(f + 2 * j, 256),
                "um_resB": res(256),
                "umm_resA": res(f + 2 * j, 256),
                "umm_resB": res(256),
                "um_comb": res(512),
                "um_fc1": conv(515, 512, 1, "q", use_bn=False),
                "um_fc2": conv(512, 512, 1, "q", use_bn=False),
                "um_head": head(512, 3 * j),
            }
            if i < cfg.num_stack - 1:
                layers["inter_out"] = head(5 * j, f)
                layers["inter_ll"] = head(f, f)
            for name, mod in layers.items():
                self.add_module(name + s, mod)

    def forward(self, dms: torch.Tensor, r_max: Optional[float] = None,
                d_max: Optional[float] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, List[torch.Tensor]]:
        if self.cfg.quantize:
            return self._forward_int8(dms)
        c = self.cfg
        dtype = c.torch_dtype
        kw = dict(r_max=r_max, d_max=d_max)
        drop = ((lambda t: dropout(t, c.dropout_rate, generator))
                if self.training else (lambda t: t))
        x = dms.permute(0, 3, 1, 2).to(dtype)                 # (b, 1, H, W)
        b = x.shape[0]

        y = self.stem_res1(self.stem_conv(x, **kw), **kw)
        y = max_pool_same(y, 2, 2)
        hg_in = self.stem_res3(self.stem_res2(y, **kw), **kw)

        out_h, out_w = c.output_hw
        # the head-grid depth (method-2 shrink) and normalized uv grid
        tiny = x[:, :, ::x.shape[2] // out_h, ::x.shape[3] // out_w]
        uu = torch.arange(out_w, dtype=dtype, device=x.device) / (out_w / 2) - 1.0
        vv = torch.arange(out_h, dtype=dtype, device=x.device) / (out_h / 2) - 1.0
        uvd = torch.cat([uu.view(1, 1, 1, out_w).expand(b, 1, out_h, out_w),
                         vv.view(1, 1, out_h, 1).expand(b, 1, out_h, out_w),
                         tiny], dim=1)
        invalid = tiny < -0.9

        outs: Dict[str, List[torch.Tensor]] = {"hm": [], "hm3": [], "um": []}
        for i in range(c.num_stack):
            m = lambda name: getattr(self, f"{name}_s{i}")
            hg = m("hg")(hg_in, **kw)
            ll = m("ll_conv")(m("ll_res")(hg, **kw), **kw)
            hm = m("hm_head")(ll)
            hm3 = m("hm3_head")(m("hm3_res")(torch.cat([ll, uvd], dim=1),
                                             **kw))

            um_cat = torch.cat([hg, hm, hm3], dim=1)
            um_in = m("um_resB")(m("um_resA")(um_cat, **kw), **kw)
            um_mask = torch.where(invalid, torch.zeros_like(um_cat), um_cat)
            um_mask = m("umm_resB")(m("umm_resA")(um_mask, **kw), **kw)
            comb = m("um_comb")(torch.cat([um_in, um_mask], dim=1), **kw)
            comb = torch.cat([comb, uvd], dim=1)
            um = drop(m("um_fc2")(drop(m("um_fc1")(comb))))
            um = m("um_head")(um)

            for key, v in (("hm", hm), ("hm3", hm3), ("um", um)):
                outs[key].append(v.float().permute(0, 2, 3, 1))

            if i < c.num_stack - 1:
                tmp = m("inter_out")(torch.cat([hm, hm3, um], dim=1))
                hg_in = hg_in + tmp + m("inter_ll")(ll)
        return outs

    def _forward_int8(self, dms: torch.Tensor):
        """The int8 net, NHWC throughout, with the JAX package's float views
        (``as_float``) in the compute dtype: concatenations, the masked
        branch, the heads and the inter-stack sum read float; every
        convolution reads int8."""
        c = self.cfg
        dtype = c.torch_dtype
        x = dms.to(dtype)                                     # (b, H, W, 1)
        b = x.shape[0]

        y = self.stem_res1(self.stem_conv(x))
        y = max_pool_same(y, 2, 2, channels_last=True)
        hg_in = self.stem_res3(self.stem_res2(y))

        out_h, out_w = c.output_hw
        tiny = x[:, ::x.shape[1] // out_h, ::x.shape[2] // out_w]
        uu = torch.arange(out_w, dtype=dtype, device=x.device) / (out_w / 2) - 1.0
        vv = torch.arange(out_h, dtype=dtype, device=x.device) / (out_h / 2) - 1.0
        uvd = torch.cat([uu.view(1, 1, out_w, 1).expand(b, out_h, out_w, 1),
                         vv.view(1, out_h, 1, 1).expand(b, out_h, out_w, 1),
                         tiny], dim=-1)
        invalid = tiny < -0.9
        cat = lambda ts: torch.cat([as_float(t) for t in ts], dim=-1)

        outs: Dict[str, List[torch.Tensor]] = {"hm": [], "hm3": [], "um": []}
        for i in range(c.num_stack):
            m = lambda name: getattr(self, f"{name}_s{i}")
            hg = m("hg")(hg_in)
            ll = m("ll_conv")(m("ll_res")(hg))
            hm = as_float(m("hm_head")(ll))
            hm3 = as_float(m("hm3_head")(m("hm3_res")(cat([ll, uvd]))))

            um_cat = cat([hg, hm, hm3])
            um_in = m("um_resB")(m("um_resA")(um_cat))
            um_mask = torch.where(invalid, torch.zeros_like(um_cat), um_cat)
            um_mask = m("umm_resB")(m("umm_resA")(um_mask))
            comb = cat([m("um_comb")(cat([um_in, um_mask])), uvd])
            um = as_float(m("um_head")(m("um_fc2")(m("um_fc1")(comb))))

            for key, v in (("hm", hm), ("hm3", hm3), ("um", um)):
                outs[key].append(v.float())

            if i < c.num_stack - 1:
                tmp = m("inter_out")(cat([hm, hm3, um]))
                hg_in = (as_float(hg_in) + as_float(tmp)
                         + as_float(m("inter_ll")(ll)))
        return outs
