"""Offline batch serving of the paper's net ``um_v1`` in calibrated int8:
``drivers/batch_int8.py``'s closed loop (one client, requests of
``request_frames`` frames run as double-buffered chunks of ``max_batch``)
on ``serving.Predictor(quantize=True, calibration=...)``, with ``um_v1``'s
seeded weights (``weights.py``) and its plain int8 reference
(``reference/int8_dense.py``).

Set-up renders the seeded pool of ``pool_frames`` and, from another seed,
``calibration_frames`` frames, on the device at the configuration's camera;
makes the net's seeded weights; builds the predictor, which calibrates its
activation scales once on those frames; draws the requests as
``drivers/batch.py`` does; and sends the first request once, which warms
the one dispatch shape (on a card: its first chunk eager, then the
forward's CUDA graph captured and replayed). Once the window has closed,
the plain int8 reference calibrates itself on the same frames and answers
the pool, in blocks of ``max_batch``; every answer of the window is
compared with it, and so is each of the program's calibrated activation
maxima (``amax_gap_rel``).

Counters, from the program's ``models.layers.int8_counts`` where it has
them: the calls made on the host by set-up's warm request, its eager and
capture forwards (a replay makes none), by K3 entry (``k3_dense``,
``k3_implicit``), ``dw`` (0 for this net), the standalone quantize steps,
the captures and replays, and ``host_forwards``, the forwards among them
that made host calls. They show the kernel mix, and are printed to
standard error.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import common
import weights
from drivers import batch, batch_int8
from reference import int8_dense, lite
from reference import serving as ref_serving


def build(cfg: dict, tr: dict, seed: int, device, quantize: bool = True,
          compute_dtype=None):
    """The cell's set-up; returns ``(pred, requests, pool, calibration,
    params, stats, cam)``, each request ``(frames, boxes, pool indices)``,
    the pool and the calibration ``(frames, boxes)``. ``quantize=False``
    (with ``compute_dtype``) serves the float net on the program's float
    path instead, a control's."""
    from densereg_torch.serving import Predictor

    gen, depth, boxes = batch_int8._render(cfg, tr["pool_frames"], seed,
                                           device)
    cam = common.camera_tensor(cfg, device)
    crops = ref_serving.normed_crops(cfg, depth[:8], boxes[:8], cam)
    params, stats = weights.serving_weights(cfg, gen, crops)
    _, cal_depth, cal_boxes = batch_int8._render(
        cfg, tr["calibration_frames"], batch_int8.calibration_seed(seed),
        device)
    net_cfg = common.net_config(dict(cfg, compute_dtype=compute_dtype
                                     or cfg["compute_dtype"]))
    pred = Predictor(weights.flax_tree(params, stats), net_cfg,
                     common.camera(cfg), device=device,
                     max_batch=tr["max_batch"], quantize=quantize,
                     calibration=(cal_depth, cal_boxes) if quantize else None)
    rng = np.random.default_rng([seed, 1])
    requests = []
    for _ in range(tr["request_sets"]):
        ix = rng.choice(tr["pool_frames"], tr["request_frames"],
                        replace=False)
        requests.append((depth[ix], boxes[ix], ix))
    return (pred, requests, (depth, boxes), (cal_depth, cal_boxes), params,
            stats, cam)


def reference(cfg, params, stats, calibration, cam, levels: int = 127):
    """The reference's quantized weights on the device and its calibrated
    activation maxima: ``(qparams, amax)``. ``levels`` 63 is a control's
    7-bit activations."""
    qparams = lite.on_device(lite.quantize_weights(lite.fold(
        params, stats, cfg["bn_epsilon"])), cam.device)
    normed = ref_serving.normed_crops(cfg, *calibration, cam)
    return qparams, int8_dense.calibrate(cfg, qparams, normed, levels)


def reference_answers(cfg, qparams, amax, pool, cam, block,
                      levels: int = 127) -> np.ndarray:
    return lite.predict(cfg, int8_dense.int8_forward(qparams, amax, levels),
                        *pool, cam, block)


def warm(pred, request, chunks: int) -> dict:
    """Send ``request`` once; the host calls it made by the program's int8
    counters (empty where the program keeps none)."""
    before = batch_int8._int8_counts()
    pred(*request[:2])
    after = batch_int8._int8_counts()
    if before is None:
        return {}
    counts = {key: after[key] - before[key] for key in before}
    counts["host_forwards"] = (chunks - counts.get("graph_replays", 0)
                               + counts.get("graph_captures", 0))
    return counts


def run(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    per = tr["request_frames"]
    chunks_per = -(-per // tr["max_batch"])
    pred, requests, pool, calibration, params, stats, cam = build(
        cfg, tr, cell.seed, dev)
    counters = warm(pred, requests[0], chunks_per)   # the one shape
    print(f"int8 host calls of set-up's warm request: "
          f"{json.dumps(counters)}", file=sys.stderr)
    order = np.random.default_rng([cell.seed, 2])
    cell.warm_profiler()
    cell.window_open()

    outs, picked, hooks = [], [], []
    t_skip, t_count = tr["trace_skip_requests"], tr["trace_requests"]
    prof = rng_window = None
    t0 = time.perf_counter()
    k = 0
    while True:
        if cell.trace and k == t_skip:
            hooks = batch._net_ranges(pred.net)
            prof = cell.start_profiler()
            rng_window = torch.autograd.profiler.record_function(
                "bench.window")
            rng_window.__enter__()
        picked.append(int(order.integers(len(requests))))
        outs.append(pred(*requests[picked[-1]][:2]))
        k += 1
        if prof is not None and k == t_skip + t_count:
            rng_window.__exit__(None, None, None)
            cell.stop_profiler(prof)
            prof = None
            for h in hooks:
                h.remove()
        if time.perf_counter() - t0 >= cell.seconds and (
                not cell.trace or k >= t_skip + t_count):
            break
    elapsed = time.perf_counter() - t0
    cell.window_close()

    got_amax = batch_int8.program_amax(pred)
    del pred
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    qparams, amax = reference(cfg, params, stats, calibration, cam)
    ref_pool = reference_answers(cfg, qparams, amax, pool, cam,
                                 tr["max_batch"])
    readings = common.serving_readings(
        batch.gaps_of(outs, requests, picked, ref_pool))
    readings["amax_gap_rel"] = lite.amax_gap_rel(got_amax, amax)
    return cell.outcome(
        attempted=k, failed=0,
        end_to_end={"frames_per_s": k * per / elapsed},
        readings=readings,
        counts={"dispatches": t_count * chunks_per,
                "frames": t_count * per, "decode_batch": tr["max_batch"]},
        counters=counters)
