"""Serving latency across batch sizes, the counterpart of
``tools/latency_probe.py``.

Times the serving program (``norm_dm`` -> the net -> the vote decode, K1
on the card) at several batch sizes: calibrated int8 on the card by
default, bfloat16 under ``--no-quant``, float32 on the CPU. Like the JAX
probe it times CHAINED iterations: each output feeds the next input
through a data dependency, with one synchronisation at the end, and
reports the best of ``--reps`` chains, the steady-state latency of a
server that keeps the card busy.

    python -m densereg_torch.tools.latency_probe [--batches 1,4,16,64,256]
        [--iters 30] [--reps 3] [--no-quant] [--net s2f128] [--device cuda]

The last line is one JSON object, ``{"metric": "serving latency sweep",
"rows": [{"batch", "latency_ms", "fps"}, ...]}``. ``build_program`` is
the program it times, the port's counterpart of ``bench._build``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch


def build_program(batch: int, compute_dtype: str, quant: bool, net_cfg,
                  device, variables=None):
    """Returns ``(infer, net, dms, cfgs, coms)``: ``infer(net, dms, cfgs,
    coms)`` (``eval.loop.make_infer_fn``) -> xyz ``(batch, 3J)`` mm, the
    serving net on ``device``, seeded depth maps ``(batch, H, W, 1)``
    (``numpy.random.default_rng(0)``, uniform 300-500 mm), the ICVL camera
    scaled to the input and centres of mass at (0, 0, 400) mm, as
    ``bench._build`` builds them.

    ``variables``: a Flax-layout tree (``{"params", "batch_stats"}``, or
    already folded); default ``models.bridge.init_variables(net_cfg,
    seed=0)``. Batch norm is folded; with ``quant`` the weights are
    quantized (``quantize_weights``) and the activation scales calibrated
    on the same maps, normalized (``calibrate``). ``compute_dtype`` is the
    net's (the int8 net's float views).
    """
    from densereg_torch import geometry
    from densereg_torch.config import CameraConfig, EvalConfig
    from densereg_torch.eval.loop import make_infer_fn
    from densereg_torch.models import (
        calibrate,
        fold_batch_norm,
        from_flax,
        init_variables,
        quantize_weights,
    )
    from densereg_torch.models.bridge import is_folded
    from densereg_torch.preprocess import norm_dm

    device = torch.device(device)
    net_cfg = dataclasses.replace(net_cfg, compute_dtype=compute_dtype)
    h, w = net_cfg.input_hw
    rng = np.random.default_rng(0)
    dms = torch.from_numpy(rng.uniform(300.0, 500.0, (batch, h, w, 1))
                           .astype(np.float32)).to(device)
    coms = torch.tensor([[0.0, 0.0, 400.0]], device=device).repeat(batch, 1)
    if variables is None:
        variables = init_variables(net_cfg, seed=0)
    if not is_folded(variables):
        variables = fold_batch_norm(variables, eps=net_cfg.bn_epsilon)
    if quant:
        net = from_flax(quantize_weights(variables), net_cfg).to(device)
        calibrate(net, [norm_dm(dms, coms)])
    else:
        net = from_flax(variables, net_cfg).to(net_cfg.torch_dtype)
        net = net.to(device)
    icvl = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
    cfgs = geometry.scale_cfg(icvl.as_array(device=device), w, h)
    cfgs = cfgs[None].repeat(batch, 1)
    infer = make_infer_fn(net.cfg, EvalConfig(batch_size=batch), device)
    return infer, net, dms, cfgs, coms


@torch.inference_mode()
def chain_ms(infer, net, dms, cfgs, coms, iters: int, reps: int) -> float:
    """Best of ``reps`` chains of ``iters`` calls, ms a call: each call's
    input is the maps plus 1e-24 times the previous call's summed xyz, and
    the host waits once, at the end of a chain."""
    xyz = infer(net, dms, cfgs, coms)
    float(xyz.sum())   # the first call builds and loads the kernels
    best = float("inf")
    for _ in range(reps):
        cur = dms
        t0 = time.perf_counter()
        for _ in range(iters):
            xyz = infer(net, cur, cfgs, coms)
            cur = dms + xyz.sum() * 1e-24
        float(xyz.sum())   # fence the chain
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


def main(argv=None) -> int:
    from densereg_torch.tools.serve_probe import net_config
    from densereg_torch.utils.device import default_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", default="1,4,16,64,256")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--net", default="s2f128",
                    help="net config s<stack>f<fea> (16 joints, 128 input)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the card (default) or the CPU")
    args = ap.parse_args(argv)

    dev = default_device(args.device)   # raises without one
    on_card = dev.type == "cuda"
    quant = on_card and not args.no_quant
    dtype = "bfloat16" if on_card else "float32"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(f"device: {dev.type} ({name}), "
          f"{'int8' if quant else dtype}", flush=True)

    rows = []
    for b in [int(x) for x in args.batches.split(",")]:
        program = build_program(b, dtype, quant, net_config(args.net), dev)
        lat = chain_ms(*program, args.iters, args.reps) / 1e3
        rows.append({"batch": b, "latency_ms": round(lat * 1e3, 3),
                     "fps": round(b / lat, 1)})
        print(f"b={b:4d}: {lat*1e3:8.3f} ms/request  "
              f"({b/lat:9.1f} frames/s)", flush=True)

    print(json.dumps({"metric": "serving latency sweep", "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
