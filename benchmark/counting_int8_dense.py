"""The yardstick of calibrated int8 ``um_v1`` (``reference/int8_dense.py``):
every call of the int8 convolution kernel K3 in one forward, in execution
order (``reference.net.conv_layers``), each tagged with the K3 entry that
runs it (``k3_dense``: 1x1 stride 1; ``k3_implicit``: the implicit GEMM of
the 3x3s and the 7x7/2 stem), with its operations and bytes counted from
the configuration's shapes by ``counting_int8``'s rule (its int8 input
read once, its weights, scale and bias, and what its consumers read of its
output, ``counting_int8.out_use``), against the H100's 3.35 TB/s and
1,979 int8 TOPS. A call's least time is the larger of its bytes over the
one and its operations over the other.
"""

from __future__ import annotations

import os
import re
from collections import defaultdict
from typing import List, Optional, Sequence

import common
import devtrace
from counting import PEAK_BYTES_PER_S
from counting_int8 import F_BYTES, PEAK_INT8_OPS, out_use
from reference import int8_dense
from reference.net import conv_layers

KINDS = ("k3_dense", "k3_implicit")


def calls(cfg: dict, batch: int = 1) -> List[dict]:
    """Every K3 call of one forward of ``batch`` frames, in execution
    order: ``kind``, ``path``, ``ops`` and ``bytes`` (the weights, scales
    and biases once a call)."""
    fb = F_BYTES[cfg["compute_dtype"]]
    out = []
    for path, cin, cout, k, s, oh, ow, _ in conv_layers(cfg):
        px_in, px_out = oh * s * ow * s, oh * ow
        use = out_use(path)
        per_px = (cout if use != "f" else 0) + (fb * cout if use != "q"
                                                 else 0)
        out.append({
            "kind": int8_dense.kind(k, s), "path": path,
            "ops": batch * 2 * px_out * cout * cin * k * k,
            "bytes": (batch * (px_in * cin + px_out * per_px)
                      + cout * cin * k * k + 8 * cout)})
    return out


def least_s(call: dict) -> float:
    return max(call["bytes"] / PEAK_BYTES_PER_S, call["ops"] / PEAK_INT8_OPS)


def bound_s(cfg: dict, batch: int, kinds: Sequence[str] = KINDS) -> float:
    """The least time of the forward's K3 calls of ``kinds`` at ``batch``
    frames, summed."""
    return sum(least_s(c) for c in calls(cfg, batch) if c["kind"] in kinds)


def forward_ops(cfg: dict) -> int:
    """Int8 operations of one frame's forward."""
    return sum(c["ops"] for c in calls(cfg))


def k3_records(run) -> list:
    """K3's kernel records in the traced window, found by the ``__global__``
    symbols of the program's ``densereg_torch/csrc/int8_gemm.cu``."""
    symbols = devtrace.kernel_symbols(os.path.join(
        common.CHECKOUT, "densereg_torch", "csrc", "int8_gemm.cu"))
    return run.trace.events(
        "kernel", "|".join(rf"\b{re.escape(s)}\b" for s in symbols))


def roofline(run) -> Optional[float]:
    """K3's share of its roofline in a traced run, %: the least time of
    all its calls of a forward at the dispatch's batch over K3's device
    time a forward (a dispatch runs one). None without a trace,
    dispatches or K3 records."""
    if run.trace is None or not run.counts.get("dispatches"):
        return None
    records = k3_records(run)
    if not records:
        return None
    per_forward = sum(e.get("dur", 0) for e in records) / 1e6 / run.counts[
        "dispatches"]
    return 100.0 * bound_s(run.config, run.counts["decode_batch"]) / \
        per_forward


def replays(run) -> List[list]:
    """K3's records of each complete graph replay of the traced window,
    in start order: the records grouped by the correlation id of the
    ``cudaGraphLaunch`` that ran them, a group kept only where it holds one
    record for each call of :func:`calls` (a trace may lose records)."""
    launches = {e.get("args", {}).get("correlation")
                for e in run.trace.by_cat["cuda_runtime"]
                + run.trace.by_cat["cuda_driver"]
                if e["name"].startswith("cudaGraphLaunch")}
    groups = defaultdict(list)
    for e in k3_records(run):
        corr = e.get("args", {}).get("correlation")
        if corr is not None and corr in launches:
            groups[corr].append(e)
    n = len(calls(run.config))
    return [sorted(g, key=lambda e: e["ts"]) for g in groups.values()
            if len(g) == n]


def implicit_roofline(run) -> Optional[float]:
    """The implicit-GEMM entry's share of its roofline, %: the least time
    of a forward's ``k3_implicit`` calls at the dispatch's batch over their
    device time a forward, each complete replay's i-th K3 record paired
    with the forward's i-th call. None without a trace or a complete
    replay."""
    if run.trace is None or not run.counts.get("decode_batch"):
        return None
    groups = replays(run)
    if not groups:
        return None
    kinds = [c["kind"] for c in calls(run.config)]
    spent = sum(e.get("dur", 0) for g in groups
                for e, k in zip(g, kinds) if k == "k3_implicit")
    if not spent:
        return None
    per_forward = spent / 1e6 / len(groups)
    return 100.0 * bound_s(run.config, run.counts["decode_batch"],
                           ("k3_implicit",)) / per_forward
