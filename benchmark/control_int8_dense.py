"""The readings that the limits of the calibrated int8 ``um_v1`` cell are
set from: ``control_int8.py``'s method for a traffic of kind
``batch_int8_dense``, the numbers the cell compares for the program on
many seeds and for the controls on a few.

    python3 benchmark/control_int8_dense.py --workload icvl16-int8-batch1024 \\
        --seeds 1,2,3 --control-seeds 4,5,6 [--device cuda]

One JSON line a seed and side. The program: the cell's predictor, set up
as the cell sets it up, answering each of its requests once, and its
calibrated activation maxima. The controls, each put in the program's
place in a lower precision than the configuration's, and compared with
the same plain int8 reference (``reference/int8_dense.py``):

* ``control_bf16_float``: the float ``um_v1`` in bfloat16, on the
  program's own float path (``Predictor(quantize=False)``); it has no
  activation maxima to compare;
* ``control_7bit``: the reference's int8 net with its activations
  quantized to +-63 (7 bits), calibrated anew in that precision.

The third control, one layer's calibrated maximum doubled in the program,
is planted on the CPU by ``benchmark/tests/test_bench_int8_dense.py``,
which runs this script at a small size too. The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH)
sys.path.append(os.path.dirname(BENCH))


def readings(cell: str, seed: int, side: str, device: str = "cuda",
             config_overrides=None, traffic_overrides=None) -> dict:
    import torch

    import common
    from drivers import batch, batch_int8, batch_int8_dense as dense
    from reference import lite

    _, _, cfg, tr = common.load_cell(cell)
    cfg = dict(cfg, **(config_overrides or {}))
    tr = dict(tr, **(traffic_overrides or {}))
    quantize = side == "program"
    pred, requests, pool, calibration, params, stats, cam = dense.build(
        cfg, tr, seed, device, quantize=quantize,
        compute_dtype=None if quantize else "bfloat16")
    picked = list(range(len(requests)))
    outs = [pred(f, b) for f, b, _ in requests]
    got_amax = batch_int8.program_amax(pred)
    del pred
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    block = tr["max_batch"]
    qparams, amax = dense.reference(cfg, params, stats, calibration, cam)
    refs = dense.reference_answers(cfg, qparams, amax, pool, cam, block)

    def read(answers, maxima=None):
        out = common.serving_readings(batch.gaps_of(answers, requests,
                                                    picked, refs))
        if maxima is not None:
            out["amax_gap_rel"] = lite.amax_gap_rel(maxima, amax)
        return out

    if quantize:
        return {"program": read(outs, got_amax)}
    q7, amax7 = dense.reference(cfg, params, stats, calibration, cam,
                                levels=63)
    ans7 = dense.reference_answers(cfg, q7, amax7, pool, cam, block,
                                   levels=63)
    return {"control_bf16_float": read(outs),
            "control_7bit": read([ans7[ix] for _, _, ix in requests],
                                 {k: float(v) for k, v in amax7.items()})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    plan = [(int(s), "program") for s in args.seeds.split(",") if s]
    plan += [(int(s), "control") for s in args.control_seeds.split(",") if s]
    for seed, side in plan:
        for kind, vals in readings(args.workload, seed, side,
                                   args.device).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": kind, **vals}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
