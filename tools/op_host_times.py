#!/usr/bin/env python3
"""Host time of the int8 nets and of a lone-frame request on the card: what
each custom-op wrapper's own cost adds up to where the kernels are short.

    python3 tools/op_host_times.py [--tree DIR] [--label NAME]

``--tree`` imports ``densereg_torch`` from another checkout (default: this
one), as ``tools/decode_kernel_times.py`` does, so that two versions can be
timed in one call on one card: run the script once per tree, in turns.
Seeded random weights (``chip_smoke.SEED``), the calibrated int8 nets with
bfloat16 views, as served. Prints one JSON line per case:

- ``int8_forward``: one forward of the int8 ``um_v1`` (s2/f128/J16,
  146 K3 calls) and ``um_v1_lite`` (K3 and the depthwise kernel) nets at
  batch 256 and 1: ``ms`` by CUDA events over back-to-back forwards,
  ``host_ms`` the host clock a forward with no synchronisation;
- ``lone_frame``: ``Predictor.__call__`` on one uint16 frame, float32 and
  calibrated int8 ``um_v1`` (K1, and K3 for int8): median wall ms over
  ``--iters`` requests.

Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import statistics
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

    from densereg_torch import NetConfig, Predictor
    from densereg_torch.models import init_variables
    from densereg_torch.models.bridge import seeded_depth
    from densereg_torch.ops import _build

    if not torch.cuda.is_available():
        print("op_host_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    label = args.label or os.path.basename(os.path.abspath(args.tree))
    cs.emit({"tool": "op_host_times", "label": label,
             "package": os.path.dirname(_build.__file__),
             "nvidia_smi": cs.gpu_name_and_power(),
             "torch": torch.__version__})
    t0 = time.perf_counter()
    _build.build()
    cs.emit({"label": label, "build_s": time.perf_counter() - t0})

    base = NetConfig(compute_dtype="bfloat16")
    rng = np.random.default_rng(cs.SEED + 3)
    dms = torch.from_numpy(seeded_depth(rng, 256, *base.input_hw))
    for module in ("um_v1", "um_v1_lite"):
        cfg = dataclasses.replace(base, net_module=module)
        net = cs.int8_net(init_variables(cfg, seed=cs.SEED), cfg, "cuda",
                          dms[:64])
        for b in (256, 1):
            x = dms[:b].cuda()
            run = torch.inference_mode()(lambda: net(x))
            cs.emit({"label": label, "case": "int8_forward",
                     "net": module, "batch": b,
                     "ms": cs.cuda_ms(run, 20),
                     "host_ms": cs.host_us(run, 20) / 1e3})
        del net
        torch.cuda.empty_cache()

    frames, bbxs = cs.hand_frames(np.random.default_rng(cs.SEED + 13), 64)
    frames = frames.astype(np.uint16)
    variables = init_variables(base, seed=cs.SEED)
    for name, cfg, kw in (
            ("float32", dataclasses.replace(base, compute_dtype="float32"),
             {}),
            ("int8", base, {"quantize": True,
                            "calibration": (frames, bbxs)})):
        pred = Predictor(variables, cfg, cs.ICVL, max_batch=1, device="cuda",
                         **kw)
        pred.warmup(with_u16=True)
        wall = []
        for i in range(args.iters):
            t1 = time.perf_counter()
            pred(frames[i % 64:i % 64 + 1], bbxs[i % 64:i % 64 + 1])
            wall.append((time.perf_counter() - t1) * 1e3)
        cs.emit({"label": label, "case": "lone_frame", "dtype": name,
                 "median_ms": statistics.median(wall),
                 "min_ms": min(wall)})
        del pred
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
