#!/usr/bin/env python3
"""Times of the vote-decode kernels on the card: the fused decode (K1) and
the weighted mean shift (K2), each against its plain version on the CPU.

    python3 tools/decode_kernel_times.py [--tree DIR] [--label NAME]

``--tree`` imports ``densereg_torch`` from another checkout (default: this
one), so that two versions of the kernels can be timed in one call on one
card: unpack the other commit with ``git archive`` into a git-ignored
directory and run the script once per tree, in turns. The inputs, timers
and bounds are this checkout's ``chip_smoke.py``'s. Prints one JSON line
per shape:

- ``device_ms``: the kernel alone, by ``torch.profiler`` (mean of 50);
- ``ms``: CUDA events around 50 back-to-back wrapper calls (the wrapper's
  host time where that is longer than the kernel);
- ``host_us``: the host clock over 1,000 wrapper calls with no
  synchronisation, divided by 1,000;
- ``max_abs_err`` against the plain version on the CPU; the bound.

K1 runs ``chip_smoke.DECODE_RUNS`` on the same scenes, in the same order
(the serving shapes with the heads as NHWC views of NCHW tensors,
``nchw``: the float32 and bfloat16 path; a lone frame; the serving bucket
channels-last, ``nhwc``, as the int8 path hands it over), then (1, 32,
32, 16) and (16, 64, 64, 16) channels-last; each row names the (frame,
joint) of its largest error. K2 runs 256 x 16
and 1 x 16 problems of 5 candidates. Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    # this checkout's chip_smoke, on the densereg_torch of --tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    from densereg_torch import decode
    from densereg_torch.ops import _build
    from densereg_torch.ops import fused_decode as fd
    from densereg_torch.ops import meanshift as k2

    if not torch.cuda.is_available():
        print("decode_kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    label = args.label or os.path.basename(os.path.abspath(args.tree))
    cs.emit({"tool": "decode_kernel_times", "label": label,
             "package": os.path.dirname(fd.__file__),
             "nvidia_smi": cs.gpu_name_and_power(),
             "torch": torch.__version__})
    t0 = time.perf_counter()
    _build.build(["fused_decode", "meanshift"])
    cs.emit({"label": label, "build_s": time.perf_counter() - t0})

    # chip_smoke's scenes first, in its order, then the other layout
    runs = cs.DECODE_RUNS + [((1, 32, 32, 16), "nhwc"),
                             ((16, 64, 64, 16), "nhwc")]
    rng = np.random.default_rng(cs.SEED)
    for (b, h, w, j), layout in runs:
        a = cs.as_served(cs.decode_scene(rng, b, h, w, j), "cuda", layout)
        got = fd.fused_decode(*a)
        torch.cuda.synchronize()
        diff = (got.cpu() - cs.plain_on_cpu(a)).abs().amax(-1)
        err = diff.max().item()
        run = lambda: fd.fused_decode(*a)
        bound_ms, bound_by = cs.decode_bound(b, h, w, j)
        cs.emit({"label": label, "name": "fused_decode", "layout": layout,
                 "shape": [b, h, w, j], "max_abs_err": err,
                 "worst_frame_joint": divmod(int(diff.argmax()), j),
                 "device_ms": cs.device_ms(run, args.iters, "fused_decode"),
                 "ms": cs.cuda_ms(run, args.iters), "host_us": cs.host_us(run),
                 "bound_ms": bound_ms, "bound_by": bound_by})

    for b, j, n in ((256, 16, 5), (1, 16, 5)):
        cans = (rng.integers(-4, 5, (b, j, n, 3)) * 0.22).astype(np.float32)
        cans += rng.normal(0.0, 0.02, cans.shape).astype(np.float32)
        wts = (rng.integers(0, 4, (b, j, n)) * 0.25).astype(np.float32)
        cans, wts = torch.from_numpy(cans), torch.from_numpy(wts)
        want = decode.weighted_mean_shift(cans, wts, 10, 0.4)
        dc, dw = cans.cuda(), wts.cuda()
        run = lambda: k2.weighted_mean_shift_cuda(dc, dw, 10, 0.4)
        err = (run().cpu() - want).abs().max().item()
        bound_ms, bound_by = cs.meanshift_bound(b * j, n)
        cs.emit({"label": label, "name": "weighted_mean_shift",
                 "shape": [b, j, n], "max_abs_err": err,
                 "device_ms": cs.device_ms(run, args.iters, "meanshift"),
                 "ms": cs.cuda_ms(run, args.iters), "host_us": cs.host_us(run),
                 "bound_ms": bound_ms, "bound_by": bound_by})
    return 0


if __name__ == "__main__":
    sys.exit(main())
