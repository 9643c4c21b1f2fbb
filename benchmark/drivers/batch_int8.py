"""Offline batch serving of the calibrated int8 lite net: ``drivers/batch.py``'s
closed loop (one client, requests of ``request_frames`` frames run as
double-buffered chunks of ``max_batch``) on ``serving.Predictor(quantize=True,
calibration=...)``.

Set-up renders the seeded pool of ``pool_frames`` and, from another seed,
``calibration_frames`` frames, on the device at the configuration's camera;
makes the lite net's seeded weights (``reference/lite_weights.py``); builds
the predictor, which calibrates its activation scales once on those frames;
and draws the requests as ``drivers/batch.py`` does. Once the window has
closed, the plain int8 reference (``reference/lite.py``) calibrates itself
on the same frames and answers the pool, in blocks of ``max_batch``; every
answer of the window is compared with it, and so is each of the program's
calibrated activation maxima (``amax_gap_rel``, the worst relative gap).

Counters over the window, from the program's ``models.layers.int8_counts``
where it has them: the int8 kernels' launches by entry, the standalone
quantize steps and the dynamic ones, and the forwards run.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import common
import frames
import weights
from drivers import batch
from reference import lite, lite_weights
from reference import serving as ref_serving


def _int8_counts():
    """The program's int8 counters, or None where it keeps none."""
    try:
        from densereg_torch.models import layers
    except ImportError:
        return None
    counts = getattr(layers, "int8_counts", None)
    return dict(counts) if counts is not None else None


def _render(cfg, n, seed, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    depth, _, boxes = frames.render(n, cfg["camera"], cfg["num_joint"], gen,
                                    device)
    return gen, depth, boxes


def calibration_seed(seed: int) -> int:
    """The seed of the calibration frames, drawn from the cell's."""
    return int(np.random.default_rng([seed, 3]).integers(2 ** 62))


def build(cfg: dict, tr: dict, seed: int, device, quantize: bool = True,
          compute_dtype=None):
    """The cell's set-up; returns ``(pred, requests, pool, calibration,
    params, stats, cam)``, each request ``(frames, boxes, pool indices)``,
    the pool and the calibration ``(frames, boxes)``. ``quantize=False``
    (with ``compute_dtype``) serves the float lite net instead, a
    control's."""
    from densereg_torch.serving import Predictor

    gen, depth, boxes = _render(cfg, tr["pool_frames"], seed, device)
    cam = common.camera_tensor(cfg, device)
    crops = ref_serving.normed_crops(cfg, depth[:8], boxes[:8], cam)
    params, stats = lite_weights.serving_weights(cfg, gen, crops)
    _, cal_depth, cal_boxes = _render(cfg, tr["calibration_frames"],
                                      calibration_seed(seed), device)
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


def program_amax(pred) -> dict:
    """The predictor's calibrated activation maxima by the reference's
    keys (``<path>/amax``, ``<path>/out_amax``)."""
    out = {}
    for name, mod in pred.net.named_modules():
        for buf in ("amax", "out_amax"):
            v = getattr(mod, buf, None)
            if isinstance(v, torch.Tensor):
                out[f"{name.replace('.', '/')}/{buf}"] = float(v)
    return out


def reference(cfg, params, stats, calibration, cam, levels: int = 127):
    """The reference's quantized weights on the device and its calibrated
    activation maxima: ``(qparams, amax)``."""
    qparams = lite.on_device(lite.quantize_weights(lite.fold(
        params, stats, cfg["bn_epsilon"])), cam.device)
    normed = ref_serving.normed_crops(cfg, *calibration, cam)
    return qparams, lite.calibrate(cfg, qparams, normed, levels)


def reference_answers(cfg, qparams, amax, pool, cam, block,
                      levels: int = 127) -> np.ndarray:
    return lite.predict(cfg, lite.int8_forward(qparams, amax, levels),
                        *pool, cam, block)


def run(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    per = tr["request_frames"]
    pred, requests, pool, calibration, params, stats, cam = build(
        cfg, tr, cell.seed, dev)
    pred(*requests[0][:2])                   # the cell's one shape, warmed
    order = np.random.default_rng([cell.seed, 2])
    cell.warm_profiler()
    cell.window_open()
    counts0 = _int8_counts()

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
    counts1 = _int8_counts()

    chunks_per = -(-per // tr["max_batch"])
    counters = {}
    if counts0 is not None:
        counters = {key: counts1[key] - counts0[key] for key in counts0}
        counters["forwards"] = k * chunks_per
    got_amax = program_amax(pred)
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
