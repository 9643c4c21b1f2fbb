#!/usr/bin/env python3
"""Where the int8 network's time goes on the card, kernel by kernel.

    python3 tools/torch_int8_profile.py [--batch 256] [--iters 3]

Builds the calibrated int8 s2/f128/J16 net of ``densereg_torch`` (seeded
random weights, bfloat16 float views, as ``chip_smoke.py`` serves it),
runs ``--iters`` forwards at ``--batch`` under ``torch.profiler`` and
prints JSON lines: the device time of each kernel name summed over the
forwards (per forward, top 20), the same by the operator that launched
it (K3, the int8 convolution kernel, is a ctypes call and has none; a
``copy_`` is split by the outermost operator that called it, e.g.
``aten::copy_ <- aten::to`` for a cast), K3's share, the forward's time by
CUDA events and the device's busy share of it. The same for the bfloat16
float net, for comparison. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import SEED, cuda_ms, gpu_name_and_power, int8_net  # noqa: E402
from densereg_torch import NetConfig  # noqa: E402
from densereg_torch.models import fold_batch_norm, from_flax  # noqa: E402
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.models.bridge import seeded_depth  # noqa: E402


def kernel_times(net, x, iters):
    """({kernel name: device microseconds per forward}, {operator: the
    device microseconds of the kernels it launched itself, per forward})."""
    with torch.inference_mode():
        net(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                net(x)
            torch.cuda.synchronize()
    times, ops = {}, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            times[evt.name] = (times.get(evt.name, 0.0)
                               + evt.time_range.elapsed_us() / iters)
        elif evt.kernels:
            name = evt.name
            if name == "aten::copy_":
                root = evt
                while root.cpu_parent is not None:
                    root = root.cpu_parent
                if root is not evt:
                    name = f"{name} <- {root.name}"
            ops[name] = ops.get(name, 0.0) + sum(
                k.duration for k in evt.kernels) / iters
    return times, ops


def report(name, net, x, iters):
    times, ops = kernel_times(net, x, iters)
    with torch.inference_mode():
        wall_ms = cuda_ms(lambda: net(x), iters)
    busy_ms = sum(times.values()) / 1e3
    top = sorted(times.items(), key=lambda kv: -kv[1])[:20]
    gemm_ms = sum(t for k, t in times.items() if "k3_kernel" in k) / 1e3
    print(json.dumps({
        "net": name, "batch": x.shape[0], "forward_ms": wall_ms,
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
        "int8_gemm_ms": gemm_ms, "kernels": len(times),
        "top_kernels_ms": [[k[:140], t / 1e3] for k, t in top],
        "by_operator_ms": [[k, t / 1e3] for k, t in sorted(
            ops.items(), key=lambda kv: -kv[1])[:20]]}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_int8_profile: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(json.dumps({"nvidia_smi": gpu_name_and_power(),
                      "torch": torch.__version__}), flush=True)
    cfg = NetConfig(compute_dtype="bfloat16")
    variables = init_variables(cfg, seed=SEED)
    x = torch.from_numpy(seeded_depth(np.random.default_rng(SEED + 3),
                                      args.batch, *cfg.input_hw)).cuda()
    report("int8", int8_net(variables, cfg, "cuda", x[:64]), x, args.iters)
    bf16 = from_flax(fold_batch_norm(variables), cfg).to(torch.bfloat16)
    report("bfloat16", bf16.cuda(), x, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
