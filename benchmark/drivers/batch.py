"""Offline batch serving: one client in a closed loop sends requests of
``request_frames`` frames and boxes to ``serving.Predictor``, which runs
each as double-buffered chunks of ``max_batch``.

The frames are a seeded pool of ``pool_frames``, rendered on the device at
the configuration's camera. Set-up draws ``request_sets`` requests from it
with the seed, each ``request_frames`` distinct frames in a seeded order,
and gathers them on the host; the window sends them back to back, each
next one chosen with the seed, until ``--seconds`` have passed, and takes
the rate over all of them. Once the window has closed, the reference
answers the pool, and every answer of the window is compared with the
reference's answers for its request's frames.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import common
import frames
import weights
from reference import net
from reference import serving as ref_serving


def _net_ranges(net_module):
    """Forward hooks that open a ``bench.net`` profiler range around each
    forward of the program's net."""
    from torch.autograd.profiler import record_function

    open_ = []

    def pre(mod, args):
        rf = record_function("bench.net")
        rf.__enter__()
        open_.append(rf)

    def post(mod, args, out):
        open_.pop().__exit__(None, None, None)

    return [net_module.register_forward_pre_hook(pre),
            net_module.register_forward_hook(post)]


def serving_setup(cfg: dict, n_frames: int, seed: int, device, **kw):
    """Seeded frames and weights, and the program's predictor over them
    (``kw`` to ``Predictor``); returns ``(pred, depth, boxes, params,
    stats, cam)``."""
    from densereg_torch.serving import Predictor

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    depth, _, boxes = frames.render(n_frames, cfg["camera"],
                                    cfg["num_joint"], gen, device)
    cam = common.camera_tensor(cfg, device)
    calib = ref_serving.normed_crops(cfg, depth[:8], boxes[:8], cam)
    params, stats = weights.serving_weights(cfg, gen, calib)
    pred = Predictor(weights.flax_tree(params, stats),
                     common.net_config(cfg), common.camera(cfg),
                     device=device, **kw)
    return pred, depth, boxes, params, stats, cam


def build(cfg: dict, tr: dict, seed: int, device, quantize: bool = False):
    """The cell's set-up: the pool, weights, the program's predictor and
    the requests; returns ``(pred, requests, pool, params, stats, cam)``,
    each request ``(frames, boxes, pool indices)`` and the pool
    ``(frames, boxes)``."""
    pred, depth, boxes, params, stats, cam = serving_setup(
        cfg, tr["pool_frames"], seed, device, max_batch=tr["max_batch"],
        quantize=quantize)
    rng = np.random.default_rng([seed, 1])
    requests = []
    for _ in range(tr["request_sets"]):
        ix = rng.choice(tr["pool_frames"], tr["request_frames"],
                        replace=False)
        requests.append((depth[ix], boxes[ix], ix))
    return pred, requests, (depth, boxes), params, stats, cam


def dtype_of(cfg: dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["compute_dtype"]]


def reference_answers(cfg, params, stats, pool, cam, block,
                      round_operands=None, tf32=False):
    """The reference's joints for every frame of the pool, in blocks of
    the program's chunk, ``block`` frames."""
    return ref_serving.predict(cfg, net.fold(params, stats), *pool, cam,
                               dtype_of(cfg), block,
                               round_operands=round_operands, tf32=tf32)


def gaps_of(outs, requests, picked, ref_pool) -> np.ndarray:
    """``(frames, joints)`` gaps of every answer ``outs[i]`` of the request
    ``requests[picked[i]]`` from the reference's answers for its frames."""
    return np.concatenate([common.joint_gaps(x, ref_pool[requests[s][2]])
                           for x, s in zip(outs, picked)])


def run(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    per = tr["request_frames"]
    pred, requests, pool, params, stats, cam = build(cfg, tr, cell.seed, dev)
    pred(*requests[0][:2])                   # the cell's one shape, warmed
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
            hooks = _net_ranges(pred.net)
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

    del pred
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_pool = reference_answers(cfg, params, stats, pool, cam,
                                 tr["max_batch"])
    chunks_per = -(-per // tr["max_batch"])
    return cell.outcome(
        attempted=k, failed=0,
        end_to_end={"frames_per_s": k * per / elapsed},
        readings=common.serving_readings(
            gaps_of(outs, requests, picked, ref_pool)),
        counts={"dispatches": t_count * chunks_per,
                "frames": t_count * per, "decode_batch": tr["max_batch"]})
