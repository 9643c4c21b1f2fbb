"""The yardstick of the int8 lite net (``reference/lite.py``): each int8
kernel call's operations and bytes, counted from the configuration's
shapes whatever implements them, and the H100's int8 peak (NVIDIA's data
sheet, SXM part, dense, at the full 700 W power limit).

Operations count 2 per multiply-add of a convolution, as
``counting.py`` counts them (a depthwise one's ``in / groups`` is 1).
Bytes of a call: its int8 input read once (the convolution's bound, not
an im2col matrix), its int8 weights, per-channel scale and bias (float32),
and the outputs its consumers read: int8 ``q`` where a convolution reads
it, the float view ``f`` (in the compute dtype) where a sum, a
concatenation or a head reads it, or both. A call's least time is the
larger of its bytes over 3.35 TB/s and its operations over the peak.
"""

from __future__ import annotations

import os
import re
from typing import List

import common
import devtrace
from counting import PEAK_BYTES_PER_S
from reference import lite

PEAK_INT8_OPS = 1979e12
F_BYTES = {"float32": 4, "bfloat16": 2}


def out_use(path: str) -> str:
    """What the consumers of the convolution at ``path`` read of its
    output: ``q`` (convolutions only), ``f`` (sums, concatenations, heads,
    the inter-stack sum) or ``both`` (``ll_conv``: ``hm3_res``'s
    concatenation reads its float, ``hm_head`` and ``inter_ll`` its
    int8)."""
    leaf = path.rsplit("/", 1)[-1].rsplit("_s", 1)[0]
    if leaf in ("conv1", "conv2", "stem_conv", "um_fc1", "um_fc2"):
        return "q"
    if leaf == "ll_conv":
        return "both"
    return "f"


def calls(cfg: dict, batch: int = 1) -> List[dict]:
    """Every int8 kernel call of one forward of ``batch`` frames, in
    execution order: ``kernel`` (``k3`` or ``dw``), ``path``, ``ops`` and
    ``bytes`` (the weights, scales and biases once a call)."""
    fb = F_BYTES[cfg["compute_dtype"]]
    out = []
    for path, cin, cout, k, s, oh, ow, _, groups in lite.conv_layers(cfg):
        px_in, px_out = oh * s * ow * s, oh * ow
        use = out_use(path)
        per_px = (cout if use != "f" else 0) + (fb * cout if use != "q"
                                                 else 0)
        out.append({
            "kernel": "dw" if groups > 1 else "k3", "path": path,
            "ops": batch * 2 * px_out * cout * (cin // groups) * k * k,
            "bytes": (batch * (px_in * cin + px_out * per_px)
                      + cout * (cin // groups) * k * k + 8 * cout)})
    return out


def bound_s(cfg: dict, kernel: str, batch: int) -> float:
    """The least time of ``kernel``'s calls of one forward of ``batch``
    frames: each call's larger of bytes and operations over their peaks,
    summed."""
    return sum(max(c["bytes"] / PEAK_BYTES_PER_S, c["ops"] / PEAK_INT8_OPS)
               for c in calls(cfg, batch) if c["kernel"] == kernel)


def forward_ops(cfg: dict) -> int:
    """Int8 operations of one frame's forward."""
    return sum(c["ops"] for c in calls(cfg))


def roofline(run, kernel: str, source: str):
    """``kernel``'s share of its roofline in a traced run, %: its least
    time a forward of the dispatch's batch (:func:`bound_s`) over its
    device time a forward (a dispatch runs one), its kernels found by the
    ``__global__`` symbols of the program's ``densereg_torch/csrc/<source>``.
    None without a trace, dispatches or such kernels."""
    if run.trace is None or not run.counts.get("dispatches"):
        return None
    symbols = devtrace.kernel_symbols(os.path.join(
        common.CHECKOUT, "densereg_torch", "csrc", source))
    calls_ = run.trace.events(
        "kernel", "|".join(rf"\b{re.escape(s)}\b" for s in symbols))
    if not calls_:
        return None
    per_forward = sum(e.get("dur", 0) for e in calls_) / 1e6 / run.counts[
        "dispatches"]
    return 100.0 * bound_s(run.config, kernel,
                           run.counts["decode_batch"]) / per_forward
