"""The readings that the limits of ``correct`` are set from: the numbers a
cell compares, for the program on many seeds and for the control on a few.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--device cuda]
    python3 benchmark/control.py --config <config> --traffic <traffic> ...

(the second form for a configuration and traffic mix that no cell of
``BENCHMARK.json`` pairs yet, such as the live cameras).

One JSON line a seed and side. The control is the computation put in the
program's place in the nearest precision below the configuration's:

* bfloat16 serving, in batches and on the daemon under the cell's load:
  the program's own int8 path (``Predictor(quantize=True)``, per-channel
  int8 weights, activations scaled by each batch);
* float32 serving: the reference with every convolution's operands rounded
  to TF32 (``reference.net.tf32``), and on a GPU also the reference with
  cuDNN's TF32 switched on;
* float32 training: the reference's steps with cuDNN's TF32 switched on
  (on a CPU, with the operands rounded to TF32); and, in the program's
  place too, the reference with a planted fault (half of each micro-batch
  left out, its loss doubled).

The benchmark's own runs never run it.
``benchmark/tests/test_bench_control.py`` runs it at a small size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.dirname(BENCH))


def batch_readings(cfg, tr, seed, device, side):
    import torch

    import common
    from drivers import batch
    from reference import net

    quantize = side == "control" and cfg["compute_dtype"] == "bfloat16"
    pred, requests, pool, params, stats, cam = batch.build(
        cfg, tr, seed, device, quantize=quantize)
    picked = list(range(len(requests)))
    outs = [pred(f, b) for f, b, _ in requests]
    del pred
    block = tr["max_batch"]
    refs = batch.reference_answers(cfg, params, stats, pool, cam, block)
    out = {}
    if side == "program" or quantize:
        out["control" if quantize else "program"] = outs
    else:
        rounded = batch.reference_answers(cfg, params, stats, pool, cam,
                                          block, round_operands=net.tf32)
        out["control_tf32_rounded"] = [rounded[ix] for _, _, ix in requests]
        if torch.device(device).type == "cuda":
            on = batch.reference_answers(cfg, params, stats, pool, cam,
                                         block, tf32=True)
            out["control_tf32_cudnn"] = [on[ix] for _, _, ix in requests]
    return {k: common.serving_readings(
        batch.gaps_of(x, requests, picked, refs)) for k, x in out.items()}


def camera_readings(cfg, tr, seed, device, side, seconds):
    """The cell's daemon under the cell's load for ``seconds``: the
    program's, or with its int8 path switched on."""
    import tempfile

    from drivers.cameras import Session

    with tempfile.TemporaryDirectory(prefix="bench-ctl-") as root:
        session = Session(cfg, tr, seed, device, root,
                          quantize=side == "control")
        try:
            _, record, _ = session.drive(tr["cameras"], seconds, seed)
        finally:
            session.close()
        return {side: session.readings(record)}


def readings(cell, seed: int, side: str, device: str = "cuda",
             config_overrides=None, traffic_overrides=None,
             seconds: float = 5.0) -> dict:
    """``cell``: a cell of ``BENCHMARK.json``, or a ``(configuration,
    traffic)`` pair of names."""
    import common

    if isinstance(cell, str):
        _, _, cfg, tr = common.load_cell(cell)
    else:
        cfg, tr = common.load_parts(*cell)
    cfg = dict(cfg, **(config_overrides or {}))
    tr = dict(tr, **(traffic_overrides or {}))
    if tr["kind"] == "batch":
        return batch_readings(cfg, tr, seed, device, side)
    if tr["kind"] == "cameras":
        return camera_readings(cfg, tr, seed, device, side, seconds)
    from drivers import train

    return train.control_readings(cfg, tr, seed, device, side)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=5.0,
                    help="the camera cell's load, a run's window")
    args = ap.parse_args(argv)
    cell = args.workload or (args.config, args.traffic)
    name = args.workload or f"{args.config}:{args.traffic}"
    plan = [(int(s), "program") for s in args.seeds.split(",") if s]
    plan += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    for seed, side in plan:
        for kind, vals in readings(cell, seed, side, args.device,
                                   seconds=args.seconds).items():
            print(json.dumps({"workload": name, "seed": seed,
                              "side": kind, **vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
