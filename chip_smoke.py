#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``densereg_torch``) on one NVIDIA GPU and
check it.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printed as one JSON line:

1. ``device``: the card's name and power limit (``nvidia-smi``), torch and
   CUDA versions.
2. ``build``: nvcc builds every ``densereg_torch/csrc/*.cu`` for sm_90a, one
   process per source, all started together.
3. ``kernel``: each kernel against its plain PyTorch version on the card, on
   seeded adversarial inputs at the shapes the serving path gives it, with
   its time (CUDA events around wrapper calls, the kernel alone by the
   profiler, the wrapper's host time), the plain version's, a library
   yardstick's and its bound: the fused decode (K1) at every head size, a
   lone frame, channels-last heads as the int8 path hands them over and
   edge-case heads (weights negative, 0, NaN, inf), then the int8
   convolution (K3) at every distinct call of the calibrated int8 net at
   batch 256, dense and implicit-GEMM, on that net's own operands; the
   depthwise int8 convolution at every distinct call of the calibrated
   (``q`` out) and the dynamic (bfloat16 ``f`` out) int8 ``um_v1_lite``
   nets at batch 256, on their operands. K1 also on the
   subnormal scene (``decode_subnormal_scene``: Gaussian weights that
   underflow, which the decode flushes to zero as XLA does).
4. ``model``: DenseRegNet s2/f128/J16 at 128x128 input (seeded random
   weights, ``init_variables``) on the card against the CPU, float32 with
   TF32 off; then the calibrated int8 net on the card (K3) against the
   same net on the CPU (K3's plain version), with its int8 steps compared
   layer by layer.
5. ``serving``: the main path. ``Predictor`` serves uint16 240x320 frames
   with boxes, 1,024 per request, in float32, bfloat16 and calibrated int8
   (bfloat16 views), then one dynamic int8 request and one lone frame; the
   kernels' launch counts (K1's by staging path, and the im2col builds on
   the card, which must stay 0) are zeroed just before and read just after.
   Then its decode is held against the plain decode on the same heads, the
   whole path against CPU predictors, and each dtype's stages and lone-frame
   latency are timed.
6. ``kernel`` once more: the weighted mean shift (K2), which no serving
   path runs, on the candidates and weights of the serving path's heads and
   on the vote's edge cases.
7. ``train``, the training path, with the kernels' counts zeroed just
   before it: synthetic shards (``train_data``); one full-width step
   (s2/f128/J16, 4 x 2, dropout 0, augmentation off, float32) on the card
   against the CPU (``train_card_vs_cpu``); ``train()`` at full width with
   the ``TrainConfig`` defaults (40 x 5) in float32 and bfloat16, 12 steps
   each, validating with K1 every 5 and keeping the best, resumed for 3
   more and served by ``Predictor.from_checkpoint``, with samples/s, the
   step's split by CUDA events, the host's issue time beside the step's
   and the device's busy share (profiler), peak memory and K1's launches
   (``train``);
   a fixed batch overfit for 30 steps (``train_overfit``).
8. ``eval``, the evaluation path, with the kernels' counts zeroed just
   before it: 300 synthetic testing frames (``eval_data``; batch 40, so
   the last batch is padded), stored once more with boxes as NYU's testing
   subset stores them; a payload written by ``convert.save_converted``
   from the seeded weights; the test driver ``train.loop.test`` on it
   (float32, TF32 off), on the boxed copy (the box crop), and with
   ``use_best`` on phase 7's float32 run; its result files checked (300
   lines in shard order, 17 error-curve lines), the first 64 frames
   against the same ``test()`` on the CPU, frames/s, one more call under
   the profiler (the device's busy share), and K1's launches by staging
   path (one a batch; K2 and K3 none).
9. ``variants``, the network variants ``um_v1_lite`` and ``um_v1_deconv``
   at the same widths, each on counts of its own: the model on the card
   against the CPU (float32), the calibrated int8 lite net step by step
   (``model_int8``); ``Predictor`` serving 3 requests of 1,024 uint16
   frames in float32, bfloat16 and, for lite, calibrated and dynamic int8
   (the depthwise kernel once a residual, 41 a forward at s2/f128, K3 for
   the other convolutions), for deconv dynamic int8 (its transposed
   convolutions float), against CPU predictors (deconv dynamic int8
   reported only: its bfloat16 transposed convolution rounds differently
   on the two), with the stages of a dispatch; the
   calibrated deconv net refused; ``train()`` in float32 at 40 x 5 for a
   few steps validating on K1; one ``test()`` on 300 frames.
10. ``tooling``, the training tooling at s2/f128/J16 on phase 7's shards,
   on counts of its own: one 40 x 5 step with and without ``remat`` from
   one state and generator seed, dropout on (loss, gradients, moving
   statistics, the generator's end state; peak memory and samples/s of
   each); ``make_fused_train_step`` against the pipeline's crop and
   ``train_step``, 3 steps from one state (the parameters; the fused
   step's samples/s); ``train()`` with scalars, histograms, validation and
   the profiler firing within 6 steps (``debug_level=0``), its event file
   read back (the histograms under the Flax key paths) and its Chrome
   trace checked for kernel events; ``_train_debug_images`` on the card;
   the host crop in float32 and on the uint16 wire against the card's crop
   (the wire's bound), in ``train()`` and in ``test()`` (result lines
   compared, joints off named with their decode flips).
11. ``daemon``, the serving daemon (``densereg_torch.serve``) on a Unix
   socket over the float32 and the calibrated int8 ``Predictor`` at
   ``max_batch`` 256, each with 4 concurrent clients of 1,024 uint16
   frames, pipelined, on counts of their own: no error reply, every
   request answered, K1 once a batch, K3 once a convolution of each int8
   forward; the answers against a direct ``Predictor`` call (joints off by
   more than 1e-3 mm counted as decode flips), frames/s, the latency
   percentiles and frames per batch of ``stats()``, the batcher's host
   time a dispatch; the same clients against a predictor that does no
   work (the daemon's own ceiling); then a flood of 1,024 requests against
   a queue of 256 (the sheds).
12. ``export``, the export artifacts (``densereg_torch.export``) at full
   width, on counts of their own: the float32 (TF32 off), bfloat16 and
   calibrated int8 ``Predictor`` at ``max_batch`` 256 exported on the card
   (float32 and uint16 entries), loaded back and held against the live
   predictor on 1,024 uint16 frames and one float32 dispatch (the largest
   joint gap, mm); K1's and K3's launches from inside the loaded programs,
   by the counters and by the profiler's kernel names (a program of the
   plain versions launches neither); the artifact's MB, export and load
   seconds, frames/s loaded against live; one ``Server`` run on the int8
   artifact.
13. ``multigpu``, data parallelism on a one-rank NCCL group
   (``densereg_torch.parallel``): one synchronized full-width training
   step against the plain step (the loss, the largest gradient and
   parameter gaps), ``Predictor(mesh=...)`` against ``Predictor`` in
   float32 and calibrated int8.

Then a ``kernels`` line (``train_launches``, ``eval_launches``,
``variants_launches``, ``tooling_launches``, ``daemon_launches``,
``export_launches``, ``multigpu_launches``: each kernel's launches in
phases 7 to 13; the depthwise kernel's ``launches`` are phase 9's), the card's ``nvidia-smi`` name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or when any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from densereg_torch import CameraConfig, EvalConfig, NetConfig, Predictor
from densereg_torch import decode
from densereg_torch.config import TrainConfig, model_desc
from densereg_torch.convert import save_converted
from densereg_torch.data import InputPipeline, ShardReader, ShardWriter
from densereg_torch.data import TestPipeline as FramePipeline
from densereg_torch.data import synthetic
from densereg_torch.eval import read_result_file
from densereg_torch.geometry import unnorm_xyz_pose
from densereg_torch.models import (
    QTensor,
    act_stats_to_flax,
    calibrate,
    fold_batch_norm,
    from_flax,
    init_train_variables,
    init_variables,
    quantize_weights,
    to_flax,
)
from densereg_torch.models import layers
from densereg_torch.models import ops as net_ops
from densereg_torch.models.bridge import seeded_depth
from densereg_torch.ops import _build
from densereg_torch.ops import fused_decode as fd
from densereg_torch.ops import int8_dwconv as dw
from densereg_torch.ops import int8_gemm as k3
from densereg_torch.ops import meanshift as k2
from densereg_torch.preprocess import (
    _bbox_from_pose,
    center_of_mass,
    crop_from_bbx,
    method2_resize,
    norm_dm,
    preprocess_batch_from_pose,
)
from densereg_torch.serve import Client, Server
from densereg_torch.train import (
    create_train_state,
    make_fused_train_step,
    train,
    train_step,
)
from densereg_torch.train.loop import (
    _make_debug_fn,
    _train_debug_images,
    _tree_tags,
)
from densereg_torch.train.loop import test as test_driver
from densereg_torch.utils.profiling import PhaseTimer
from densereg_torch.utils.tb import EventWriter, read_events
from densereg_torch.wire import error_bound as wire_error_bound

SEED = 0
ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160.0, cy=120.0, w=320.0,
                    h=240.0)
# H100 SXM data sheet: HBM rate, float32 rate outside the tensor cores and
# the tensor cores' dense int8 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12

K1_TOL = 6e-6        # normalized units (PARITY.md, fused-decode row)
K2_TOL = 6e-6        # the same limit for the mean-shift stage alone
HEAD_TOL = 1e-4      # per head element (PARITY.md, network row)
XYZ_TOL_MM = 0.02    # decode's 2e-4 normalized bound (PARITY.md) in mm
RESULT_ROUNDING_MM = 1e-4   # the result file's %.4f
# one training step, card against CPU (the CPU tests' limits against JAX):
# the loss, each parameter's averaged gradient by relative norm (the float32
# reduction-order floor through the renorm backward) and the moving
# statistics
LOSS_RTOL = 2e-4
GRAD_REL_TOL = 5e-2
STATS_RTOL, STATS_ATOL = 2e-3, 2e-5
TRAIN_STEPS, RESUME_STEPS = 12, 3
# (batch, head h, head w, joints): the serving bucket of 256 at 128 input
# first, then the other joint counts and the 256- and 512-input heads
DECODE_SHAPES = [(256, 32, 32, 16), (8, 32, 32, 14), (8, 32, 32, 21),
                 (16, 64, 64, 16), (4, 128, 128, 16)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, kernel: str, warmup: int = 2, tries: int = 3):
    """Mean device milliseconds of one launch of the CUDA kernel whose name
    holds ``kernel`` (each call of ``fn`` launches it once), by
    ``torch.profiler`` over ``iters`` calls: the kernel's own time, without
    the host's launch gaps that ``cuda_ms`` counts when a call is shorter
    than its Python wrapper. The profiler now and then loses a window's
    kernel records: the mean is over the launches it recorded, a window
    with none is taken again, and after ``tries`` such windows the result
    is None."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if us:
            return sum(us) / len(us) / 1e3
    return None


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls with no
    synchronisation between them: the wrapper's own cost where the kernel
    is shorter than it (the launch queue absorbs the launches)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


# --------------------------------------------------------------------------
# kernel: fused decode (K1)
# --------------------------------------------------------------------------

def decode_scene(rng, b: int, h: int, w: int, j: int):
    """Adversarial decode inputs as numpy arrays ``(hms, hm3s, ums, tiny,
    cfgs, coms)``: scores on a coarse grid, so exact ties occur in the top-k
    and in the vote grid; ~15% background pixels (depth -1); unit offsets;
    centers of mass spread so that some candidates reproject off-image.
    Frame 0 has no heatmap mass, so every candidate weight is 0."""
    hms = (rng.integers(0, 5, (b, h, w, j)) * 0.25).astype(np.float32)
    hms[0] = 0.0
    hm3s = (rng.integers(0, 5, (b, h, w, j)) * np.float32(0.2)).astype(
        np.float32)
    um = rng.normal(size=(b, h, w, j, 3)).astype(np.float32)
    um /= np.linalg.norm(um, axis=-1, keepdims=True) + 1e-6
    tiny = rng.uniform(-0.8, 1.0, (b, h, w, 1)).astype(np.float32)
    tiny[rng.random((b, h, w, 1)) < 0.15] = -1.0
    cam = np.asarray(ICVL, np.float32)
    in_w, in_h = 4 * w, 4 * h              # intrinsics of the network input
    rx, ry = cam[4] / in_w, cam[5] / in_h
    cfg = np.array([cam[0] / rx, cam[1] / ry, cam[2] / rx, cam[3] / ry,
                    in_w, in_h], np.float32)
    cfgs = np.tile(cfg, (b, 1))
    coms = np.stack([rng.uniform(-40, 40, b), rng.uniform(-40, 40, b),
                     rng.uniform(350, 450, b)], -1).astype(np.float32)
    return hms, hm3s, um.reshape(b, h, w, 3 * j), tiny, cfgs, coms


def decode_edge_scene(rng, b: int, h: int, w: int, j: int):
    """``decode_scene`` with the vote's edge cases in frames 1-4 (b >= 5):
    every heatmap negative (every weight negative), every heatmap -1 (the
    scores all 0, -0 on the background), and one pixel of joint 0 with a
    NaN heatmap, one of joint 1 with an infinite one, each with hm3 = 1 so
    that it is picked and its candidate reprojects onto it: a NaN and an
    infinite weight."""
    hms, hm3s, ums, tiny, cfgs, coms = decode_scene(rng, b, h, w, j)
    hms[1] = -rng.integers(1, 5, (h, w, j)) * np.float32(0.25)
    hms[2] = -1.0
    for f, jj, val in ((3, 0, np.nan), (4, 1, np.inf)):
        y, x = h // 2, w // 2
        hms[f, y, x, jj] = val
        hm3s[f, y, x, jj] = 1.0
        tiny[f, y, x, 0] = 0.4
    return hms, hm3s, ums, tiny, cfgs, coms


def decode_subnormal_scene(rng, b: int, h: int, w: int, j: int):
    """``decode_scene`` with, in every frame but the first, every other
    joint's five candidates on a cluster of pixels some 600 mm behind the
    center of mass (normalized depth 2.50-2.62, hm = hm3 = 1 there, so the
    cluster is the top-5 and each candidate weighs 1): the vote starts in
    the nearest edge cell, 28-32 squared normalized units away, where the
    Gaussian weight exp(-3.125 d^2) lies in float32's subnormal range or
    just above it. XLA flushes such a weight to 0 (a joint whose weights
    are all subnormal keeps its start); the decode must do the same."""
    hms, hm3s, ums, tiny, cfgs, coms = decode_scene(rng, b, h, w, j)
    cy, cx = h // 2, w // 2
    for f in range(1, b):
        for jj in range(0, j, 2):
            y0 = cy + int(rng.integers(-1, 2))
            x0 = cx + int(rng.integers(-1, 2))
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1), (0, -1)):
                hms[f, y0 + dy, x0 + dx, jj] = 1.0
                hm3s[f, y0 + dy, x0 + dx, jj] = 1.0
                tiny[f, y0 + dy, x0 + dx, 0] = rng.uniform(2.50, 2.62)
    return hms, hm3s, ums, tiny, cfgs, coms


def as_served(scene, device, layout: str = "nchw"):
    """Tensors laid out as the serving path hands them to the decode, the
    head-grid depth a ``[::4, ::4]`` view of the full-size normalized depth
    and the heads NHWC views of NCHW tensors (``nchw``), channels-last
    (``nhwc``: the int8 net), or ``mixed``: a channels-last ``hm`` beside
    NCHW ``hm3`` and ``um`` (the float nets)."""
    hms, hm3s, ums, tiny, cfgs, coms = (torch.from_numpy(a).to(device)
                                        for a in scene)
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    heads = [t.contiguous() if layout == "nhwc"
             or (layout == "mixed" and i == 0) else nchw(t)
             for i, t in enumerate((hms, hm3s, ums))]
    b, h, w, _ = tiny.shape
    full = torch.full((b, 4 * h, 4 * w, 1), -1.0, device=device)
    full[:, ::4, ::4] = tiny
    return (*heads, full[:, ::4, ::4], cfgs, coms)


# the staging path K1 takes for each layout (J % 4 == 0)
K1_PATH = {"nchw": "planes", "nhwc": "pixels", "mixed": "hm_pixels"}


def decode_bound(b, h, w, j, num_pt=5, num_it=10):
    """Least time of the fused decode on an H100 (ms) and what sets it.

    Bytes: hm, hm3 and the depth read in full, ``(2j + 1) hw`` floats a
    frame; 6 floats gathered at each of the ``num_pt * j`` picks (um x3,
    depth, hm3, hm at the reprojection); cfg, com and the output. Operations:
    5 a (pixel, joint) for the score and the top-k test, 64 a candidate for
    the vote grid, 20 a candidate and mean-shift step."""
    hw = h * w
    nbytes = 4 * b * ((2 * j + 1) * hw + 6 * num_pt * j + 9 + 3 * j)
    ops = b * j * (5 * hw + num_pt * (64 + 20 * num_it))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def topk_gather_stage(scores, ums, k: int = 5):
    """The library yardstick: ``torch.sort`` top-k (stable: ties to the
    lower index) and the gather of the offsets at the picks, which is only
    one stage of the fused decode."""
    b, j, hw = scores.shape
    idx = torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]
    um = ums.reshape(b, hw, j, 3).transpose(1, 2)
    return torch.gather(um, 2, idx[..., None].expand(-1, -1, -1, 3))


def plain_on_cpu(args):
    """The plain decode of the same inputs, evaluated on the CPU. On CUDA
    tensors PyTorch's own kernels round differently (a division by a Python
    scalar goes through its reciprocal; exp differs in the last bit), and
    the mean shift magnifies a last-bit change in the Gaussian weight of a
    far candidate to ~1e-5. The kernel divides and exponentiates in IEEE
    float32, as the CPU does."""
    return fd.fused_decode_reference(*(t.cpu() for t in args))


def nan_equal_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| where both are finite; inf where either is NaN
    or infinite and the other is not the same."""
    both = torch.isfinite(got) & torch.isfinite(want)
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    if not bool((both | same).all()):
        return float("inf")
    return float((got - want).where(both, 0.0).abs().max())


# (shape, layout): the serving bucket as the float nets hand it over, the
# head sizes and joint counts with NCHW heads, a lone frame, and the
# serving bucket as the int8 net hands it over
DECODE_RUNS = ([((256, 32, 32, 16), "mixed")]
               + [(s, "nchw") for s in DECODE_SHAPES]
               + [((1, 32, 32, 16), "mixed"), ((256, 32, 32, 16), "nhwc")])


def phase_kernel(device, runs=DECODE_RUNS, iters: int = 50):
    """K1 on each run and on the edge-case frames in both layouts, against
    the plain decode on the CPU; each row says which staging path the
    launch took, which must be the one its layout is for."""
    rng = np.random.default_rng(SEED)
    rows = []
    for (b, h, w, j), layout in runs:
        args = as_served(decode_scene(rng, b, h, w, j), device, layout)
        paths = dict(fd.fused_decode.launches_by_path)
        got = fd.fused_decode(*args)
        torch.cuda.synchronize()
        path = [p for p, n in fd.fused_decode.launches_by_path.items()
                if n != paths[p]]
        err = (got.cpu() - plain_on_cpu(args)).abs().max().item()
        err_card = (got - fd.fused_decode_reference(*args)).abs().max().item()
        scores = decode.refined_heatmaps(*args[:2], args[3]).reshape(
            b, h * w, j).transpose(1, 2).contiguous()
        bound_ms, bound_by = decode_bound(b, h, w, j)
        run = lambda: fd.fused_decode(*args)
        row = {"phase": "kernel", "name": "fused_decode",
               "shape": {"b": b, "h": h, "w": w, "j": j}, "layout": layout,
               "path": path, "max_abs_err": err, "vs_plain_on_card": err_card,
               "ms": cuda_ms(run, iters),
               "device_ms": device_ms(run, iters, "fused_decode"),
               "host_us": host_us(run),
               "plain_ms": cuda_ms(lambda: fd.fused_decode_reference(*args),
                                   max(iters // 10, 3)),
               "library_ms": cuda_ms(lambda: topk_gather_stage(scores,
                                                               args[2]),
                                     iters),
               "bound_ms": bound_ms, "bound_by": bound_by}
        emit(row)
        check(bool(torch.isfinite(got).all()), f"decode {b, h, w, j}: NaN")
        check(err <= K1_TOL, f"fused_decode {b, h, w, j}: max |err| {err} "
                             f"> {K1_TOL}")
        check(path == [K1_PATH[layout]], f"fused_decode {b, h, w, j} "
                                         f"{layout}: took {path}")
        rows.append(row)
    scene = decode_edge_scene(rng, 8, 32, 32, 16)
    for layout in K1_PATH:
        args = as_served(scene, device, layout)
        got = fd.fused_decode(*args)
        torch.cuda.synchronize()
        want = plain_on_cpu(args)
        err = nan_equal_err(got.cpu(), want)
        emit({"phase": "kernel", "name": "fused_decode", "edge_cases": True,
              "shape": {"b": 8, "h": 32, "w": 32, "j": 16}, "layout": layout,
              "max_abs_err": err,
              "nan_joints": int(torch.isnan(want).any(-1).sum())})
        check(err <= K1_TOL, f"fused_decode edge cases {layout}: max |err| "
                             f"{err} > {K1_TOL}")
    scene = decode_subnormal_scene(rng, 8, 32, 32, 16)
    for layout in K1_PATH:
        args = as_served(scene, device, layout)
        got = fd.fused_decode(*args)
        torch.cuda.synchronize()
        err = (got.cpu() - plain_on_cpu(args)).abs().max().item()
        emit({"phase": "kernel", "name": "fused_decode",
              "subnormal_scene": True,
              "shape": {"b": 8, "h": 32, "w": 32, "j": 16}, "layout": layout,
              "max_abs_err": err,
              "joints_all_subnormal": subnormal_joints(args)})
        check(err <= K1_TOL, f"fused_decode subnormal scene {layout}: max "
                             f"|err| {err} > {K1_TOL}")
    return rows


def subnormal_joints(args):
    """Joints of a decode scene whose first mean-shift step's Gaussian
    weights, in IEEE float32, would all be subnormal (flushed: the start
    stays)."""
    _, cans, w = decode.decode_plain(*(t.cpu() for t in args))
    start = decode._vote_grid_init(cans, w).double()
    s = torch.exp(-3.125 * ((cans.double() - start[..., None, :]) ** 2).sum(
        -1)) * w.double()
    return int(((s > 0) & (s < torch.finfo(torch.float32).tiny)).all(
        -1).sum())


# --------------------------------------------------------------------------
# kernel: int8 GEMM with requantisation (K3)
# --------------------------------------------------------------------------

def int8_net(variables, net_cfg: NetConfig, device, calib):
    """The calibrated int8 net of ``variables`` (folded, quantized) on
    ``device``, calibrated on the normalized depth ``calib``."""
    qtree = quantize_weights(fold_batch_norm(variables, net_cfg.bn_epsilon))
    net = from_flax(qtree, net_cfg).to(device)
    return calibrate(net, [calib.to(device)])


def record_gemm_calls(net, x):
    """Run ``net(x)`` once with both K3 entries spied on. Returns the
    distinct calls, ``{(route, M, K, N, relu, emit_q, emit_f, f_dtype):
    (args, kwargs, calls per forward)}``, each with the operands of its
    first call; ``route`` is ``dense`` (``int8_gemm_requant``) or
    ``implicit`` (``int8_conv_requant``), whose K is the im2col GEMM's,
    k * k * C."""
    real = layers.int8_gemm_requant, layers.int8_conv_requant
    calls = {}

    def record(route, m, k, n, args, kw):
        key = (route, m, k, n, kw["relu"], kw["emit_q"], kw["emit_f"],
               str(kw["f_dtype"]).split(".")[-1])
        if key not in calls:
            calls[key] = [args, kw, 0]
        calls[key][2] += 1

    def dense(x_q, w_q, scale, bias, s_y=None, **kw):
        record("dense", x_q.shape[0], x_q.shape[1], w_q.shape[1],
               (x_q, w_q, scale, bias, s_y), kw)
        return real[0](x_q, w_q, scale, bias, s_y, **kw)

    def implicit(x_q, w, k, stride, scale, bias, s_y=None, **kw):
        b, h, wd, c = x_q.shape
        m = b * -(-h // stride) * -(-wd // stride)
        record("implicit", m, k * k * c, w.shape[0],
               (x_q, w, k, stride, scale, bias, s_y), kw)
        return real[1](x_q, w, k, stride, scale, bias, s_y, **kw)

    layers.int8_gemm_requant, layers.int8_conv_requant = dense, implicit
    try:
        with torch.inference_mode():
            net(x)
    finally:
        layers.int8_gemm_requant, layers.int8_conv_requant = real
    return calls


def gemm_bound(m, k, n, emit_q, emit_f, f_bytes, x_bytes=None):
    """Least time of one call (ms), as (bytes time, operations time): x
    (``x_bytes``, default the (M, K) matrix), w, scale and bias read once,
    q and f written once; 2MKN int8 operations. With the default x it is
    the im2col-bytes bound of a k x k convolution (``bound_ms``, the bound
    of an im2col GEMM); with ``x_bytes`` the activation's b*h*w*C bytes,
    the convolution's own (``conv_bound_ms``)."""
    x_bytes = m * k if x_bytes is None else x_bytes
    nbytes = x_bytes + k * n + 8 * n + m * n * (int(emit_q)
                                                + f_bytes * int(emit_f))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / INT8_OPS_PER_S * 1e3
    return t_bytes, t_ops


def int_mm_call(x_q, w_q, scale, bias, s_y, relu, emit_q, emit_f, f_dtype):
    """The library yardstick: ``torch._int_mm`` (cuBLASLt int8, which takes
    K and N in multiples of 8: the operands are zero-padded to them before
    the timing) and the same epilogue in torch. Returns a closure."""
    m, k = x_q.shape
    n = w_q.shape[1]
    kp, np8 = -(-k // 8) * 8, -(-n // 8) * 8
    a = torch.zeros((m, kp), dtype=torch.int8, device=x_q.device)
    a[:, :k] = x_q
    b = torch.zeros((kp, np8), dtype=torch.int8, device=x_q.device)
    b[:k, :n] = w_q

    def call():
        y = torch._int_mm(a, b)[:, :n].float() * scale + bias
        if relu:
            y = torch.clamp_min(y, 0.0)
        q = k3.quantize(y, s_y) if emit_q else None
        f = y.to(f_dtype) if emit_f else None
        return q, f
    return call


def scramble_pitch(x_q: torch.Tensor, rng) -> int:
    """Overwrite the pitch bytes of an NHWC int8 view (those between C and
    the pixel pitch, which no producer writes) with random int8; returns
    how many there were."""
    c, pitch = x_q.shape[-1], x_q.stride(-2)
    if pitch == c:
        return 0
    with torch.inference_mode():      # the net's operands are inference tensors
        full = x_q.as_strided(x_q.shape[:-1] + (pitch,), x_q.stride())
        pad = full[..., c:]
        pad.copy_(torch.from_numpy(rng.integers(
            -128, 128, tuple(pad.shape)).astype(np.int8)).to(x_q.device))
    return pad.numel()


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two float32 or
    bfloat16 tensors of one sign pattern (0 and -0 are 0 apart)."""
    if a.dtype == torch.bfloat16:
        a, b = a.float(), b.float()     # exact; count in bfloat16 steps
        scale = 2 ** 16
    else:
        scale = 1
    ia = (a + 0.0).view(torch.int32).long()
    ib = (b + 0.0).view(torch.int32).long()
    return int(((ia - ib).abs() // scale).max().item())


def per_forward(rows, key):
    """The sum over one forward of ``key``: each distinct call's value
    times its calls a forward; None where any call lacks the value (a
    device time the profiler did not read), so that no total is short."""
    if any(r[key] is None for r in rows):
        return None
    return sum(r[key] * r["calls_per_forward"] for r in rows)


def phase_kernel_int8(variables, net_cfg: NetConfig, device, b: int = 256,
                      iters: int = 20):
    """K3 at every distinct call of the calibrated int8 net (bfloat16
    views, as served) at batch ``b``, on that net's operands (the pitch
    bytes of each implicit call's activation scrambled first), against its
    plain version on the card: ``q`` bit-identical and ``f`` within 1 ulp.
    ``ms`` times back-to-back wrapper calls by CUDA events (at the small
    maps that is the wrapper's host time), ``device_ms`` the kernel alone
    by the profiler. Each line has both bounds: ``bound_ms`` counts the
    im2col matrix as x (an im2col GEMM's bound), ``conv_bound_ms`` each
    activation byte once. An implicit call adds ``im2col_ms``, the time of
    the im2col that its plain version and the library yardstick
    (``library_ms``, which excludes it) start from. Returns the rows and
    the per-forward totals."""
    cfg = NetConfig(**{**net_cfg.__dict__, "compute_dtype": "bfloat16"})
    rng = np.random.default_rng(SEED + 3)
    dms = torch.from_numpy(seeded_depth(rng, b, *cfg.input_hw))
    net = int8_net(variables, cfg, device, dms[:64])
    calls = record_gemm_calls(net, dms.to(device))
    rows = []
    for (route, m, k, n, relu, emit_q, emit_f, fdt), (args, kw, count) in \
            sorted(calls.items(), key=lambda kv: -kv[0][1] * kv[0][2]
                   * kv[0][3]):
        shape = {"M": m, "K": k, "N": n, "relu": relu, "emit_q": emit_q,
                 "emit_f": emit_f, "f_dtype": fdt}
        if route == "implicit":
            x_q, w, win, stride = args[:4]
            bb, h, wd, c = x_q.shape
            shape.update(k=win, stride=stride, h=h, w=wd, C=c)
            pitch_bytes = scramble_pitch(x_q, rng)
            run = lambda: k3.int8_conv_requant(*args, **kw)
            plain = lambda: k3.int8_conv_requant_reference(*args, **kw)
            im2col = lambda: k3.im2col_nhwc(x_q, win, stride)
            cols, _ = im2col()
            library = int_mm_call(cols, k3.unpack_weight(w, win, c),
                                  *args[4:], **kw)
            x_bytes = bb * h * wd * c
        else:
            pitch_bytes, im2col = 0, None
            run = lambda: k3.int8_gemm_requant(*args, **kw)
            plain = lambda: k3.int8_gemm_requant_reference(*args, **kw)
            library = int_mm_call(*args, **kw)
            x_bytes = None
        q, f = run()
        q_p, f_p = plain()
        torch.cuda.synchronize()
        q_bad = 0 if q is None else int((q != q_p).sum().item())
        f_ulps = 0 if f is None else ulps(f, f_p)
        f_err = 0.0 if f is None else (f.float() - f_p.float()).abs().max(
            ).item()
        f_bytes = 0 if f is None else f.element_size()
        t_bytes, t_ops = gemm_bound(m, k, n, emit_q, emit_f, f_bytes)
        c_bytes, _ = gemm_bound(m, k, n, emit_q, emit_f, f_bytes, x_bytes)
        row = {"phase": "kernel", "name": "int8_gemm_requant",
               "route": route, "shape": shape, "calls_per_forward": count,
               "pitch_bytes_scrambled": pitch_bytes, "q_mismatches": q_bad,
               "f_max_ulps": f_ulps, "max_abs_err": f_err,
               "ms": cuda_ms(run, iters),
               "device_ms": device_ms(run, iters, "k3_kernel"),
               "plain_ms": cuda_ms(plain, 3),
               "library_ms": cuda_ms(library, iters),
               "im2col_ms": cuda_ms(im2col, iters) if im2col else 0.0,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes_ms": t_bytes, "ops_ms": t_ops,
               "conv_bound_ms": max(c_bytes, t_ops),
               "conv_bound_by": ("bytes" if c_bytes >= t_ops
                                 else "operations"),
               "conv_bytes_ms": c_bytes}
        emit(row)
        check(q_bad == 0, f"int8 K3 {route} {m, k, n}: {q_bad} int8 "
                          f"outputs differ from the plain version")
        check(f_ulps <= 1, f"int8 K3 {route} {m, k, n}: f {f_ulps} ulps off")
        rows.append(row)
    # one forward: each distinct call times the number of such calls
    total = {key: per_forward(rows, key)
             for key in ("ms", "device_ms", "plain_ms", "library_ms",
                         "im2col_ms",
                         "bound_ms", "bytes_ms", "ops_ms", "conv_bound_ms",
                         "conv_bytes_ms")}
    total["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                         else "operations")
    total["conv_bound_by"] = ("bytes" if total["conv_bytes_ms"]
                              >= total["ops_ms"] else "operations")
    total["calls_per_forward"] = sum(r["calls_per_forward"] for r in rows)
    total["calls_without_device_ms"] = sum(
        r["calls_per_forward"] for r in rows if r["device_ms"] is None)
    total["calls_by_route"] = {
        route: sum(r["calls_per_forward"] for r in rows
                   if r["route"] == route) for route in ("dense", "implicit")}
    total["ops_per_forward"] = sum(2 * r["shape"]["M"] * r["shape"]["K"]
                                   * r["shape"]["N"] * r["calls_per_forward"]
                                   for r in rows)
    total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    emit({"phase": "kernel", "name": "int8_gemm_requant", "batch": b,
          "distinct_calls": len(rows), "per_forward": total})
    return rows, total


# --------------------------------------------------------------------------
# kernel: depthwise int8 convolution (the um_v1_lite int8 net's)
# --------------------------------------------------------------------------

def record_dw_calls(net, x):
    """Run ``net(x)`` once with the depthwise kernel's wrapper spied on.
    Returns the distinct calls, ``{(b, h, w, C, k, relu, emit_q, emit_f,
    f_dtype): (args, kwargs, calls per forward)}``, each with the operands
    of its first call."""
    real = layers.int8_dwconv_requant
    calls = {}

    def spy(x_q, w, k, scale, bias, s_y=None, **kw):
        key = (*x_q.shape, k, kw["relu"], kw["emit_q"], kw["emit_f"],
               str(kw["f_dtype"]).split(".")[-1])
        if key not in calls:
            calls[key] = [(x_q, w, k, scale, bias, s_y), kw, 0]
        calls[key][2] += 1
        return real(x_q, w, k, scale, bias, s_y, **kw)

    layers.int8_dwconv_requant = spy
    try:
        with torch.inference_mode():
            net(x)
    finally:
        layers.int8_dwconv_requant = real
    return calls


def dw_bound(b, h, w, c, k, emit_q, f_bytes):
    """Least time of one depthwise call (ms), as (bytes time, operations
    time): the activation read once (b*h*w*C bytes), the taps, scale and
    bias once, q (1 byte) and f (``f_bytes``) written once; 2 k^2 int8
    operations an output at the int8 peak."""
    out = b * h * w * c
    nbytes = out + k * k * c + 8 * c + out * (int(emit_q) + f_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * k * k * out / INT8_OPS_PER_S * 1e3
    return t_bytes, t_ops


def dw_library_call(x_q, w_packed, k, scale, bias, s_y, relu, emit_q, emit_f,
                    f_dtype):
    """The library yardstick: cuDNN's grouped convolution
    (``F.conv2d(groups=C)``) in float32 on the int8 values cast to float
    (exact: k^2 * 127^2 < 2^24), then the plain epilogue. The cast is made
    once, outside the call. Returns a closure."""
    c = x_q.shape[-1]
    xf = x_q.permute(0, 3, 1, 2).float()
    wf = w_packed[:, :c].t().reshape(c, 1, k, k).float()

    def call():
        acc = F.conv2d(xf, wf, padding=k // 2, groups=c).permute(0, 2, 3, 1)
        return k3.requant_reference(acc, scale, bias, s_y, relu=relu,
                                    emit_q=emit_q, emit_f=emit_f,
                                    f_dtype=f_dtype)
    return call


def phase_kernel_dwconv(variables, net_cfg: NetConfig, device, b: int = 256,
                        iters: int = 20):
    """The depthwise kernel at every distinct call of the two int8
    ``um_v1_lite`` nets served (bfloat16 views) at batch ``b``: the
    calibrated one, whose calls hand on ``q`` alone, and the dynamic one,
    whose calls hand on the bfloat16 ``f`` alone; on each net's operands
    (the pitch bytes of each activation scrambled first), against the plain
    version on the card: ``q`` bit-identical and ``f`` within 1 ulp. Times
    as K3's rows (``ms`` by events, ``device_ms`` by the profiler,
    ``host_us`` a wrapper call), the plain version's, the library
    yardstick's and the bound. Returns the per-forward totals of each net,
    ``{"calibrated": ..., "dynamic": ...}``."""
    cfg = dataclasses.replace(net_cfg, compute_dtype="bfloat16")
    rng = np.random.default_rng(SEED + 3)
    dms = torch.from_numpy(seeded_depth(rng, b, *cfg.input_hw))
    nets = {"calibrated": int8_net(variables, cfg, device, dms[:64]),
            "dynamic": from_flax(quantize_weights(fold_batch_norm(
                variables, cfg.bn_epsilon)), cfg).to(device)}
    residuals = sum(isinstance(m, layers.Residual)
                    for m in nets["calibrated"].modules())
    totals = {}
    for kind, net in nets.items():
        calls = record_dw_calls(net, dms.to(device))
        rows = []
        for key, (args, kw, count) in sorted(
                calls.items(), key=lambda kv: -np.prod(kv[0][:4])):
            rows.append(dw_row(kind, key, args, kw, count, rng, iters))
        total = {k: per_forward(rows, k)
                 for k in ("ms", "device_ms", "plain_ms", "library_ms",
                           "bound_ms", "bytes_ms", "ops_ms")}
        total["bound_by"] = ("bytes" if total["bytes_ms"] >= total["ops_ms"]
                             else "operations")
        total["calls_per_forward"] = sum(r["calls_per_forward"] for r in rows)
        total["calls_without_device_ms"] = sum(
            r["calls_per_forward"] for r in rows if r["device_ms"] is None)
        total["calls_with_f"] = sum(r["calls_per_forward"] for r in rows
                                    if r["shape"]["emit_f"])
        total["host_us_mean"] = statistics.mean(r["host_us"] for r in rows)
        total["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        emit({"phase": "kernel", "name": "int8_dwconv_requant", "net": kind,
              "batch": b, "distinct_calls": len(rows),
              "residuals": residuals, "per_forward": total})
        check(total["calls_per_forward"] == residuals,
              f"int8_dwconv {kind}: {total['calls_per_forward']} calls a "
              f"forward, {residuals} residuals")
        totals[kind] = total
    # the dynamic net's calls are the ones that emit f: every one must have
    # been held against the plain version's f
    check(totals["dynamic"]["calls_with_f"] == residuals,
          f"int8_dwconv dynamic: {totals['dynamic']['calls_with_f']} of "
          f"{residuals} calls a forward emitted f")
    return totals


def dw_row(kind, key, args, kw, count, rng, iters):
    """One distinct depthwise call: the kernel against its plain version,
    its times and its bound (an emitted row)."""
    bb, h, wd, c, k = key[:5]
    pitch_bytes = scramble_pitch(args[0], rng)
    run = lambda: dw.int8_dwconv_requant(*args, **kw)
    plain = lambda: dw.int8_dwconv_requant_reference(*args, **kw)
    q, f = run()
    q_p, f_p = plain()
    torch.cuda.synchronize()
    q_bad = 0 if q is None else int((q != q_p).sum().item())
    f_ulps = None if f is None else ulps(f, f_p)
    f_err = 0.0 if f is None else (f.float() - f_p.float()).abs().max(
        ).item()
    t_bytes, t_ops = dw_bound(bb, h, wd, c, k, kw["emit_q"],
                              0 if f is None else f.element_size())
    row = {"phase": "kernel", "name": "int8_dwconv_requant", "net": kind,
           "shape": {"b": bb, "h": h, "w": wd, "C": c, "k": k,
                     "relu": kw["relu"], "emit_q": kw["emit_q"],
                     "emit_f": kw["emit_f"], "f_dtype": key[-1]},
           "vector_path": args[0].stride(2) % 16 == 0,
           "calls_per_forward": count,
           "pitch_bytes_scrambled": pitch_bytes, "q_mismatches": q_bad,
           "f_max_ulps": f_ulps, "max_abs_err": f_err,
           "ms": cuda_ms(run, iters),
           "device_ms": device_ms(run, iters, "dw_kernel"),
           "host_us": host_us(run, 200),
           "plain_ms": cuda_ms(plain, 3),
           "library_ms": cuda_ms(dw_library_call(*args, **kw), iters),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_ms": t_bytes, "ops_ms": t_ops}
    emit(row)
    check((q is None) == (not kw["emit_q"]) and (f is None) == (
        not kw["emit_f"]), f"int8_dwconv {kind} {key}: outputs "
                           f"{q is not None, f is not None} not as asked")
    check(q_bad == 0, f"int8_dwconv {kind} {key}: {q_bad} int8 outputs "
                      f"differ from the plain version")
    check(f is None or f_ulps <= 1,
          f"int8_dwconv {kind} {key}: f {f_ulps} ulps off")
    return row


# --------------------------------------------------------------------------
# kernel: weighted mean shift (K2), off the serving path
# --------------------------------------------------------------------------

def meanshift_bound(p, n, num_it=10):
    """Least time (ms) of P problems of n candidates: the candidates and
    weights read once, the centers written once; 64 compares a candidate
    for the vote and 20 operations a candidate and step."""
    nbytes = 4 * p * (4 * n + 3)
    ops = p * n * (64 + 20 * num_it)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def vote_edge_cases(seed: int = SEED):
    """The vote's edge cases, ``{name: (cans (P, n, 3), weights (P, n))}``
    as float32 numpy arrays, a few problems each. Cells over [-1, 1]^3 at a
    grid of 4: a coordinate below -0.5 is index 0, at or above 0.5 index
    3; cell 0 is (-0.75,) * 3, cell 63 (0.75,) * 3, cell 62 (0.75, 0.75,
    0.25)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    hi, lo = f32(0.75), f32(-0.75)

    def spread(p, n, a=-0.9, b=0.9):
        return rng.uniform(a, b, (p, n, 3)).astype(f32)

    cases = {}
    # every weight negative: the last empty cell starts (63, then 62, 61)
    cans = spread(3, 5, -0.9, -0.1)
    cans[1, 0] = cans[2, 0] = hi
    cans[2, 1] = [hi, hi, 0.25]
    cases["all_negative"] = (cans, -rng.uniform(0.1, 1.0, (3, 5)).astype(f32))
    # an occupied vote of exactly 0 beside empty cells (0.5 - 0.5, or
    # zeros, or -0): the later index wins the tie
    cans = spread(4, 5, -0.9, -0.6)
    cans[0, :2] = hi
    cans[3, 0] = hi
    w = np.full((4, 5), -0.25, f32)
    w[0, :2] = w[1, :2] = [0.5, -0.5]
    w[2] = 0.0
    w[3] = -0.0
    cases["zero_vote"] = (cans, w)
    # every candidate in one cell: cell 0, then cell 63
    cans = np.stack([lo + spread(1, 5, -0.2, 0.2)[0],
                     hi + spread(1, 5, -0.2, 0.2)[0]])
    cases["one_cell"] = (cans, rng.uniform(0.1, 1.0, (2, 5)).astype(f32))
    # coordinates at and past +-1 (clipped into the outer cells)
    edge = np.array([-3.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 3.0], f32)
    cases["at_and_past_edges"] = (rng.choice(edge, (3, 5, 3)).astype(f32),
                                  rng.uniform(0.1, 1.0, (3, 5)).astype(f32))
    # NaN coordinates quantize to index 0 (all three NaN: cell 0); the mean
    # shift's weight sum is then NaN and the start is kept
    cans = spread(2, 5)
    cans[0, 1] = np.nan
    cans[1, 0, 0] = np.nan
    w = rng.uniform(0.1, 1.0, (2, 5)).astype(f32)
    w[0, 1] = 5.0
    cases["nan_candidates"] = (cans, w)
    # a NaN weight makes every cell's vote NaN: cell 63 starts, as argmax
    # takes the last NaN, and the NaN weight sum keeps it
    cans = spread(2, 5)
    cans[1, 3] = hi
    w = rng.uniform(0.1, 1.0, (2, 5)).astype(f32)
    w[0, 2] = w[1, 3] = np.nan
    cases["nan_weight"] = (cans, w)
    # an infinite weight makes every other cell's vote NaN (inf * 0): 63,
    # or 62 where the infinity sits in 63; inf - inf in one cell is NaN
    cans = spread(4, 5, -0.9, 0.4)
    cans[1, 2] = hi
    cans[3, 1] = cans[3, 3] = [0.1, 0.1, 0.1]
    w = rng.uniform(0.1, 1.0, (4, 5)).astype(f32)
    w[0, 2] = w[1, 2] = w[3, 1] = np.inf
    w[2, 4] = w[3, 3] = -np.inf
    cases["inf_weight"] = (cans, w)
    # one candidate, and eight (ties between cells, a zero-weight problem)
    for n in (1, 8):
        cans = (rng.integers(-4, 5, (6, n, 3)) * 0.22).astype(f32)
        w = (rng.integers(-1, 4, (6, n)) * 0.25).astype(f32)
        w[0] = 0.0
        cases[f"n{n}"] = (cans, w)
    return cases


def phase_kernel_meanshift(heads, ecfg, device, iters: int = 50):
    """K2 on the candidates and weights that the plain decode (on the CPU)
    draws from the serving path's heads, against the plain mean shift on
    the CPU; then on the vote's edge cases (NaN and infinite results
    compared as values)."""
    heads = tuple(t.cpu() for t in heads)
    _, cans, weights = decode.decode_plain(*heads, ecfg)
    want = decode.weighted_mean_shift(cans, weights, ecfg.mean_shift_iters,
                                      ecfg.band_width, ecfg.vote_grid)
    d_cans, d_w = cans.to(device), weights.to(device)
    run = lambda: k2.weighted_mean_shift_cuda(
        d_cans, d_w, ecfg.mean_shift_iters, ecfg.band_width, ecfg.vote_grid)
    got = run()
    torch.cuda.synchronize()
    err = (got.cpu() - want).abs().max().item()
    b, j, n, _ = cans.shape
    bound_ms, bound_by = meanshift_bound(b * j, n, ecfg.mean_shift_iters)
    edge = {}
    _, s_cans, s_w = decode.decode_plain(*(torch.from_numpy(a) for a in
                                           decode_subnormal_scene(
                                               np.random.default_rng(SEED),
                                               8, 32, 32, 16)))
    cases = {**vote_edge_cases(),
             "subnormal_scene": (s_cans.flatten(0, 1).numpy(),
                                 s_w.flatten(0, 1).numpy())}
    for name, (e_cans, e_w) in cases.items():
        e_cans, e_w = torch.from_numpy(e_cans), torch.from_numpy(e_w)
        e_got = k2.weighted_mean_shift_cuda(e_cans[None].to(device),
                                            e_w[None].to(device))[0]
        edge[name] = nan_equal_err(e_got.cpu(), decode.weighted_mean_shift(
            e_cans, e_w, 10, 0.4))
    row = {"phase": "kernel", "name": "weighted_mean_shift",
           "shape": {"b": b, "j": j, "n": n},
           "zero_weight_problems": int((weights == 0).all(-1).sum()),
           "max_abs_err": max(err, *edge.values()), "serving_err": err,
           "edge_case_errs": edge,
           "ms": cuda_ms(run, iters),
           "device_ms": device_ms(run, iters, "meanshift"),
           "host_us": host_us(run),
           "plain_ms": cuda_ms(lambda: decode.weighted_mean_shift(
               d_cans, d_w, ecfg.mean_shift_iters, ecfg.band_width,
               ecfg.vote_grid), 5),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    emit(row)
    check(bool(torch.isfinite(got).all()), "weighted_mean_shift: NaN")
    check(row["max_abs_err"] <= K2_TOL,
          f"weighted_mean_shift: max |err| {row['max_abs_err']} > {K2_TOL} "
          f"(edge cases: {edge})")
    return row


# --------------------------------------------------------------------------
# model and serving
# --------------------------------------------------------------------------

def phase_model(variables, net_cfg: NetConfig, device, b: int = 2):
    """Heads of the unfolded float32 net on ``device`` against the CPU."""
    x = torch.from_numpy(seeded_depth(np.random.default_rng(SEED + 1), b,
                                      *net_cfg.input_hw))
    with torch.inference_mode():
        want = from_flax(variables, net_cfg)(x)
        got = from_flax(variables, net_cfg).to(device)(x.to(device))
    errs = {k: max((g.cpu() - w).abs().max().item()
                   for g, w in zip(got[k], want[k])) for k in want}
    scale = {k: want[k][-1].abs().max().item() for k in want}
    emit({"phase": "model", "config": net_cfg.__dict__, "batch": b,
          "max_abs_err": errs, "max_abs_head": scale, "tol": HEAD_TOL})
    for k, e in errs.items():
        check(e <= HEAD_TOL, f"model head {k}: card vs CPU {e} > {HEAD_TOL}")


def int8_steps(net, x):
    """Heads of ``net(x)`` and the int8 side of every :class:`QTensor` that
    a layer hands on, on the CPU, by layer name."""
    qs = {}
    hook = lambda name: lambda mod, args, out: (
        qs.__setitem__(name, out.q.cpu())
        if isinstance(out, QTensor) and out.q is not None else None)
    handles = [m.register_forward_hook(hook(name))
               for name, m in net.named_modules() if hasattr(m, "calibrating")]
    try:
        with torch.inference_mode():
            heads = net(x)
    finally:
        for h in handles:
            h.remove()
    return {k: [t.cpu() for t in v] for k, v in heads.items()}, qs


def phase_model_int8(variables, net_cfg: NetConfig, device, b: int = 2):
    """The calibrated int8 net (float32 views) on ``device`` (K3) against
    the same net on the CPU (K3's plain version), with the statistics the
    CPU recorded: head error and the int8 outputs that differ, layer by
    layer."""
    x = torch.from_numpy(seeded_depth(np.random.default_rng(SEED + 1), b,
                                      *net_cfg.input_hw))
    cpu = int8_net(variables, net_cfg, "cpu", x)
    qtree = {**quantize_weights(fold_batch_norm(variables,
                                                net_cfg.bn_epsilon)),
             "act_stats": act_stats_to_flax(cpu)}
    card = from_flax(qtree, net_cfg).to(device)
    want, q_want = int8_steps(cpu, x)
    got, q_got = int8_steps(card, x.to(device))
    errs = {k: max((g - w).abs().max().item() for g, w in zip(got[k],
                                                               want[k]))
            for k in want}
    flips = {k: int((q_got[k] != q).sum()) for k, q in q_want.items()}
    emit({"phase": "model_int8", "config": net_cfg.__dict__, "batch": b,
          "max_abs_err": errs, "layers_compared": len(flips),
          "int8_steps_compared": sum(q.numel() for q in q_want.values()),
          "int8_steps_flipped": sum(flips.values()),
          "layers_with_flips": {k: v for k, v in flips.items() if v},
          "tol": HEAD_TOL})
    check(q_got.keys() == q_want.keys() and len(flips) > 100,
          "model_int8: the card and the CPU nets quantize other layers")
    for k, e in errs.items():
        check(e <= HEAD_TOL, f"int8 model head {k}: card vs CPU {e} > "
                             f"{HEAD_TOL}")


def hand_frames(rng, b: int):
    """uint16 240x320 depth frames (mm): a noisy tilted ellipse, the hand at
    350-450 mm, over a 900 mm background, and a box around each."""
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    frames = np.empty((b, 240, 320), np.uint16)
    bbxs = np.zeros((b, 5), np.float32)
    for i in range(b):
        cy, cx = rng.uniform(90, 150), rng.uniform(120, 200)
        ry, rx = rng.uniform(30, 60), rng.uniform(30, 60)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        surf = (rng.uniform(350, 450) + 0.5 * (yy - cy)
                + rng.normal(0, 3.0, yy.shape))
        frames[i] = np.round(np.where(inside, surf, 900.0))
        bbxs[i] = [cy - ry - 8, cx - rx - 5, cy + ry + 6, cx + rx + 9,
                   float(surf[int(cy), int(cx)]) + 120.0]
    return frames, bbxs


def decode_flips(heads_a, heads_b, ecfg):
    """Per (frame, joint): whether the plain decode crosses one of its
    discontinuities between two sets of heads (CPU tensors): another
    candidate pixel, another weight pixel or another vote-grid cell."""
    na, ca, wa = decode.decode_plain(*heads_a, ecfg)
    nb, cb, wb = decode.decode_plain(*heads_b, ecfg)
    pick = (ca - cb).abs().amax(dim=(-1, -2)) > 1e-3
    weight = (wa - wb).abs().amax(dim=-1) > 1e-3
    cell = (decode._vote_grid_init(ca, wa, ecfg.vote_grid)
            != decode._vote_grid_init(cb, wb, ecfg.vote_grid)).any(dim=-1)
    return pick | weight | cell


def phase_serving(variables, device, net_cfg: NetConfig = NetConfig(),
                  n_frames: int = 1024, max_batch: int = 256,
                  buckets=(1, 64, 256), reps: int = 3, n_cpu: int = 8,
                  n_calib: int = 64):
    """The main path. Returns the launch counts of the run, the predictors,
    and the frames and boxes served."""
    rng = np.random.default_rng(SEED + 2)
    distinct, bbxs = hand_frames(rng, min(n_frames, 256))
    tile = -(-n_frames // len(distinct))
    frames = np.tile(distinct, (tile, 1, 1))[:n_frames]
    bbxs = np.tile(bbxs, (tile, 1))[:n_frames]
    # int8 serves as bench.py serves it: calibrated, bfloat16 float views
    calib = hand_frames(np.random.default_rng(SEED + 4), n_calib)
    bf16 = NetConfig(**{**net_cfg.__dict__, "compute_dtype": "bfloat16"})

    preds = {}
    t0 = time.perf_counter()
    for name, cfg, kw in (
            ("float32", NetConfig(**{**net_cfg.__dict__,
                                     "compute_dtype": "float32"}), {}),
            ("bfloat16", bf16, {}),
            ("int8", bf16, dict(quantize=True, calibration=calib)),
            ("int8_dynamic", bf16, dict(quantize=True))):
        preds[name] = Predictor(variables, cfg, ICVL, max_batch=max_batch,
                                batch_buckets=buckets, device=device, **kw)
        preds[name].warmup()
    warmup_s = time.perf_counter() - t0
    convs = sum(1 for m in preds["int8"].net.modules()
                if isinstance(m, layers.ConvBR))

    # the main path: counts zeroed just before, read just after
    fd.fused_decode.launches = 0
    fd.fused_decode.launches_by_path = dict.fromkeys(fd.PATHS, 0)
    k3.int8_gemm_requant.launches = 0
    k2.weighted_mean_shift_cuda.launches = 0
    dw.int8_dwconv_requant.launches = 0
    k3.im2col_nhwc.cuda_calls = 0
    secs, xyz = {}, {}
    for name in ("float32", "bfloat16", "int8"):
        secs[name] = []
        for _ in range(reps):
            t0 = time.perf_counter()
            xyz[name] = preds[name](frames, bbxs)
            secs[name].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    xyz["int8_dynamic"] = preds["int8_dynamic"](frames, bbxs)
    secs["int8_dynamic"] = [time.perf_counter() - t0]
    lone = preds["float32"](frames[:1], bbxs[:1])
    launches = {"fused_decode": fd.fused_decode.launches,
                "fused_decode_by_path": dict(fd.fused_decode.launches_by_path),
                "int8_gemm_requant": k3.int8_gemm_requant.launches,
                "weighted_mean_shift": k2.weighted_mean_shift_cuda.launches,
                "int8_dwconv_requant": dw.int8_dwconv_requant.launches}
    im2col_on_card = k3.im2col_nhwc.cuda_calls
    decode_strides = {
        name: [t.stride() for t in pred._heads(
            pred._to_device(frames[:1]), pred._to_device(bbxs[:1]))[:4]]
        for name, pred in preds.items()}
    per_request = -(-n_frames // max_batch)
    int8_dispatches = (reps + 1) * per_request
    dispatches = 2 * reps * per_request + int8_dispatches + 1

    on_cuda = torch.device(device).type == "cuda"
    emit({"phase": "serving", "config": net_cfg.__dict__,
          "frames_per_request": n_frames, "frame_hw": [240, 320],
          "frame_dtype": "uint16", "max_batch": max_batch,
          "batch_buckets": list(preds["float32"].batch_buckets),
          "int8": {"compute_dtype": "bfloat16", "calibration_frames": n_calib,
                   "convs_per_forward": convs},
          "warmup_s": warmup_s,
          "frames_per_s": {d: n_frames / statistics.median(s)
                           for d, s in secs.items()},
          "request_s": secs, "dispatches": dispatches,
          "int8_dispatches": int8_dispatches, "launches": launches,
          "decode_input_strides": decode_strides,
          "im2col_nhwc_cuda_calls": im2col_on_card})
    j3 = 3 * net_cfg.num_joint
    for name, out in xyz.items():
        check(out.shape == (n_frames, j3) and bool(np.isfinite(out).all()),
              f"serving {name}: shape {out.shape} or non-finite xyz")
    if on_cuda:
        check(launches["fused_decode"] == dispatches,
              f"fused_decode launched {launches['fused_decode']} times in "
              f"{dispatches} dispatches")
        # the float nets' heads (channels-last hm, NCHW hm3) take the
        # hm_pixels path, the int8 net's channels-last heads the pixels path
        want_paths = dict.fromkeys(fd.PATHS, 0)
        want_paths.update(hm_pixels=dispatches - int8_dispatches,
                          pixels=int8_dispatches)
        check(launches["fused_decode_by_path"] == want_paths,
              f"fused_decode paths {launches['fused_decode_by_path']}, "
              f"expected {want_paths} (decode inputs' strides: "
              f"{decode_strides})")
        check(launches["int8_gemm_requant"] == convs * int8_dispatches,
              f"int8_gemm_requant launched {launches['int8_gemm_requant']} "
              f"times, not {convs} convolutions x {int8_dispatches} "
              f"dispatches")
        check(im2col_on_card == 0,
              f"{im2col_on_card} int8 convolutions built an im2col on the "
              f"card instead of running K3's implicit GEMM")
        check(launches["int8_dwconv_requant"] == 0,
              "um_v1 serving launched the depthwise kernel")
    else:
        check(not any(v if isinstance(v, int) else any(v.values())
                      for v in launches.values()),
              "a kernel launched on the CPU")

    # the kernel against the plain decode on the served heads
    b = min(n_frames, max_batch)
    dev_frames = torch.from_numpy(frames[:b]).to(device)
    dev_bbxs = torch.from_numpy(bbxs[:b]).to(device)
    checks = {}
    for name, pred in preds.items():
        heads = pred._heads(dev_frames, dev_bbxs)
        normed = decode.decode_poses(*heads, pred.ecfg)["normed"]
        err = (normed.cpu() - plain_on_cpu(heads)).abs().max().item()
        check(err <= K1_TOL, f"serving {name}: kernel vs plain decode {err}")
        xyz_k = unnorm_xyz_pose(normed.reshape(b, -1), heads[5]).cpu().numpy()
        checks[name] = {"kernel_vs_plain_normed": err,
                        "served_vs_heads_decode_mm": float(
                            np.abs(xyz_k - xyz[name][:b]).max())}
    for name in ("bfloat16", "int8", "int8_dynamic"):
        gap = np.linalg.norm((xyz[name] - xyz["float32"]).reshape(
            n_frames, -1, 3), axis=-1)
        checks[f"{name}_vs_float32_mm"] = {"median": float(np.median(gap)),
                                           "max": float(gap.max())}
    checks["lone_vs_batched_mm"] = float(np.abs(lone[0]
                                                - xyz["float32"][0]).max())

    # the whole path against CPU predictors on the same weights (int8: and
    # the statistics the card recorded)
    n = min(n_cpu, n_frames)
    qtree = {**quantize_weights(fold_batch_norm(variables,
                                                net_cfg.bn_epsilon)),
             "act_stats": act_stats_to_flax(preds["int8"].net)}
    for name, cpu in (("float32", Predictor(variables, net_cfg, ICVL,
                                            max_batch=n, device="cpu")),
                      ("int8", Predictor(qtree, bf16, ICVL, max_batch=n,
                                         device="cpu"))):
        checks[f"card_vs_cpu_{name}"] = card_vs_cpu(
            preds[name], cpu, frames[:n], bbxs[:n], dev_frames[:n],
            dev_bbxs[:n])
    emit({"phase": "serving_checks", **checks})
    for name in ("float32", "int8"):
        c = checks[f"card_vs_cpu_{name}"]
        check(c["joints_off_without_a_flip"] == 0,
              f"card vs CPU {name}: {c['joints_off_without_a_flip']} joints "
              f"off by more than {XYZ_TOL_MM} mm with no decode flip")
    check(checks["card_vs_cpu_float32"]["max_head_err"] <= HEAD_TOL,
          f"card vs CPU heads {checks['card_vs_cpu_float32']['max_head_err']}")

    emit({"phase": "serving_stages", "batch": b,
          **{d: stage_ms(p, frames[:b], bbxs[:b]) for d, p in preds.items()},
          "lone_frame": {d: lone_frame_ms(p, frames, bbxs)
                         for d, p in preds.items()}})
    return launches, preds, frames, bbxs


def card_vs_cpu(pred, cpu, frames, bbxs, dev_frames, dev_bbxs):
    """A card predictor against a CPU one on the same requests: xyz, the
    heads, and the joints where the plain decode crosses a discontinuity
    between the two sets of heads."""
    n = len(frames)
    heads_cpu = cpu._heads(torch.from_numpy(frames), torch.from_numpy(bbxs))
    heads_dev = tuple(t.cpu() for t in pred._heads(dev_frames, dev_bbxs))
    got = pred(frames, bbxs).reshape(n, -1, 3)
    want = cpu(frames, bbxs).reshape(n, -1, 3)
    off = np.abs(got - want).max(axis=-1) > XYZ_TOL_MM
    flips = decode_flips(heads_cpu, heads_dev, cpu.ecfg).numpy()
    return {"frames": n, "joints": int(off.size),
            "max_mm": float(np.abs(got - want).max()),
            "max_mm_without_flips": float(np.abs(got - want)[~flips].max(
                initial=0.0)),
            "joints_off": int(off.sum()),
            "joints_at_a_decode_flip": int(flips.sum()),
            "joints_off_without_a_flip": int((off & ~flips).sum()),
            "max_head_err": max((a - c).abs().max().item()
                                for a, c in zip(heads_dev[:3], heads_cpu[:3]))}


@torch.inference_mode()
def stage_ms(pred: Predictor, frames: np.ndarray, bbxs: np.ndarray,
             iters: int = 10):
    """Milliseconds of each stage of one dispatch, by CUDA events: the
    host-to-device copy (pinning included), crop + center of mass + depth
    normalization, the network, the decode."""
    in_h, in_w = pred.net_cfg.input_hw
    dev_frames = pred._to_device(frames)
    dev_bbxs = pred._to_device(bbxs)

    def preprocess():
        dms, cfgs = crop_from_bbx(dev_frames, dev_bbxs, pred._cam, in_h, in_w)
        return norm_dm(dms, center_of_mass(dms, cfgs))

    normed = preprocess()
    heads = pred._heads(dev_frames, dev_bbxs)
    return {"host_to_device": cuda_ms(lambda: pred._to_device(frames), iters),
            "preprocess": cuda_ms(preprocess, iters),
            "network": cuda_ms(lambda: pred.net(normed), iters),
            "decode": cuda_ms(lambda: decode.decode_poses(*heads, pred.ecfg),
                              iters)}


def lone_frame_ms(pred: Predictor, frames: np.ndarray, bbxs: np.ndarray,
                  n: int = 20):
    """Latency of a lone frame (bucket 1): the median of ``n`` one-frame
    requests by the host clock (each ends in the copy of its result to the
    host, so in a synchronisation), frames taken in turn; and the decode's
    share, its CUDA-event time at batch 1 over that median."""
    secs = []
    for i in range(n + 1):
        i %= len(frames)
        t0 = time.perf_counter()
        pred(frames[i:i + 1], bbxs[i:i + 1])
        secs.append(time.perf_counter() - t0)
    median_ms = statistics.median(secs[1:]) * 1e3
    with torch.inference_mode():
        heads = pred._heads(pred._to_device(frames[:1]),
                            pred._to_device(bbxs[:1]))
        dec = cuda_ms(lambda: decode.decode_poses(*heads, pred.ecfg), 20)
    return {"requests": n, "median_ms": median_ms,
            "min_ms": min(secs[1:]) * 1e3, "decode_ms": dec,
            "decode_share": dec / median_ms}


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def train_data(root: str, shards: int = 4, per_shard: int = 64):
    """Synthetic training and validation shards (the port's
    ``data/synthetic.py``), validation from another seed."""
    t0 = time.perf_counter()
    spec = synthetic.make_spec("training", directory=root, num_shards=shards,
                               samples_per_shard=per_shard, seed=SEED)
    val = synthetic.make_spec("validation", directory=root, num_shards=1,
                              samples_per_shard=per_shard, seed=SEED + 1)
    emit({"phase": "train_data", "train_frames": spec.exact_num,
          "validation_frames": val.exact_num, "frame_hw": [240, 320],
          "joints": spec.jnt_num, "seconds": time.perf_counter() - t0})
    return spec, val


def pose_crops(spec, n: int, input_hw, device):
    """The first ``n`` frames of ``spec`` cropped around their poses
    (``TestPipeline``), on ``device``."""
    batch = next(iter(FramePipeline(spec, n, input_hw, device=device)))
    return {k: v for k, v in batch.items() if k != "name"}


def phase_train_card_vs_cpu(spec, net_cfg: NetConfig, device, sub: int = 2,
                            b: int = 4):
    """One training step at full width from the same training-init weights,
    batch ``b`` x sub_batch ``sub``, dropout 0, augmentation off, float32
    (TF32 off), on the card and on the CPU: the loss, every parameter's
    averaged gradient (before the clip) and the moving statistics."""
    cfg = dataclasses.replace(net_cfg, dropout_rate=0.0,
                              compute_dtype="float32")
    tcfg = TrainConfig(batch_size=b, sub_batch=sub, augment=False)
    variables = init_train_variables(cfg, SEED)
    crops = pose_crops(spec, sub * b, cfg.input_hw, "cpu")
    batch = {k: v.reshape((sub, b) + tuple(v.shape[1:]))
             for k, v in crops.items()}
    out = {}
    for dev in (device, "cpu"):
        state = create_train_state(cfg, tcfg, 100.0, variables=variables,
                                   device=dev)
        t0 = time.perf_counter()
        m = train_step(state, {k: v.to(dev) for k, v in batch.items()}, cfg,
                       tcfg, with_grads=True)
        loss = float(m["loss"])
        out[dev] = (loss, {k: g.cpu().double() for k, g in m["grads"].items()},
                    {k: v.cpu() for k, v in state.net.state_dict().items()
                     if k.endswith((".mean", ".var"))},
                    time.perf_counter() - t0)
    (l_d, g_d, s_d, t_d), (l_c, g_c, s_c, t_c) = out[device], out["cpu"]
    grad_rel = {k: float((g_d[k] - g).norm() / (g.norm() + 1e-30))
                for k, g in g_c.items()}
    worst = max(grad_rel, key=grad_rel.get)
    stats_excess = max(float(((s_d[k] - v).abs()
                               - (STATS_ATOL + STATS_RTOL * v.abs())).max())
                       for k, v in s_c.items())
    row = {"phase": "train_card_vs_cpu", "config": cfg.__dict__,
           "batch": [sub, b], "loss_card": l_d, "loss_cpu": l_c,
           "loss_rel_diff": abs(l_d - l_c) / abs(l_c),
           "max_grad_rel_norm": grad_rel[worst], "worst_param": worst,
           "median_grad_rel_norm": statistics.median(grad_rel.values()),
           "params": len(grad_rel),
           "stats_max_excess_over_tol": stats_excess,
           "step_s": {"card_first_call": t_d, "cpu": t_c},
           "tol": {"loss_rtol": LOSS_RTOL, "grad_rel_norm": GRAD_REL_TOL,
                   "stats_rtol": STATS_RTOL, "stats_atol": STATS_ATOL}}
    emit(row)
    check(np.isfinite(l_d) and row["loss_rel_diff"] <= LOSS_RTOL,
          f"train step card vs CPU: loss {l_d} vs {l_c}")
    check(grad_rel[worst] <= GRAD_REL_TOL,
          f"train step card vs CPU: gradient of {worst} off by "
          f"{grad_rel[worst]} (relative norm)")
    check(stats_excess <= 0.0, f"train step card vs CPU: moving statistics "
                               f"off by {stats_excess} over the tolerance")
    return row


def step_split(state, spec, cfg: NetConfig, tcfg: TrainConfig, device,
               steps: int = 3):
    """Device milliseconds of a training step's phases (CUDA events), the
    mean over ``steps`` steps after one more: the feed (pinned copy and
    crop), augmentation and targets, forward and backward, the optimizer.
    Returns the split and the last batch."""
    pipe = InputPipeline(spec, tcfg.batch_size, tcfg.sub_batch,
                         cfg.input_hw, seed=SEED + 5, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 5)
    timer = PhaseTimer()
    totals = {}
    try:
        it = iter(pipe)
        for i in range(steps + 1):
            torch.cuda.synchronize()
            timer.start()
            batch = next(it)
            timer.mark("feed_preprocess")
            train_step(state, batch, cfg, tcfg, gen, mark=timer.mark)
            split = timer.split()
            if i:
                for k, v in split.items():
                    totals[k] = totals.get(k, 0.0) + v / steps
    finally:
        pipe.close()
    totals["step"] = sum(totals.values())
    return totals, batch


def step_profile(state, batch, cfg: NetConfig, tcfg: TrainConfig, device,
                 reps: int = 3, top: int = 12):
    """Whether the host holds a training step back: the host's time to
    issue a step (the call returns before the device is done) beside the
    step's time after a device sync, the median of ``reps``; then one step
    under ``torch.profiler``: the device's busy time and share, its
    activities (kernels and copies), and the device time by the operator
    that launched it (top ``top``)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 6)
    step = lambda: train_step(state, batch, cfg, tcfg, gen)
    step()
    torch.cuda.synchronize()
    host, wall = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        step()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    step_ms = statistics.median(wall) * 1e3
    return {"step_ms": step_ms,
            "host_issue_ms": statistics.median(host) * 1e3,
            **device_time(prof, step_ms, top)}


def device_time(prof, wall_ms: float, top: int):
    """From a ``torch.profiler`` trace: the device's busy time and its
    share of ``wall_ms``, its activities (kernels and copies), and the
    device time by the operator that launched it (top ``top``)."""
    busy_us, activities, ops = 0.0, 0, {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += evt.time_range.elapsed_us()
            activities += 1
        elif evt.kernels:
            ops[evt.name] = ops.get(evt.name, 0.0) + sum(
                k.duration for k in evt.kernels) / 1e3
    return {"device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / wall_ms,
            "device_activities": activities,
            "by_operator_ms": dict(sorted(ops.items(),
                                          key=lambda kv: -kv[1])[:top])}


def pose_boxes(poses: torch.Tensor, cfg: CameraConfig, threshold: float):
    """Serving boxes ``(b, 5)`` from poses: the trainer's pose crop box and
    a fixed depth threshold."""
    box = _bbox_from_pose(poses, cfg.as_array(), 20.0)
    return torch.stack([v.float() for v in box]
                       + [torch.full_like(box[0], threshold, dtype=torch.float32)],
                       dim=-1).numpy()


def phase_train_run(spec, val, net_cfg: NetConfig, dtype: str, root: str,
                    device):
    """``train()`` at full width with the ``TrainConfig`` defaults (40 x 5,
    augmentation on, dropout 0.5) for ``TRAIN_STEPS`` steps, validating
    every 5 and keeping the best; a resume from its last checkpoint for
    ``RESUME_STEPS`` more; the checkpoint served by
    ``Predictor.from_checkpoint``; then a step's split by CUDA events and
    its profile (host issue time against step time, device busy share)."""
    cfg = dataclasses.replace(net_cfg, compute_dtype=dtype)
    tcfg = TrainConfig(base_dir=os.path.join(root, dtype), validate_every=5,
                       keep_best=True, summary_every=1)
    train_dir = os.path.join(tcfg.base_dir, model_desc(
        spec.name, spec.subset, cfg, tcfg.augment))
    quiet = lambda *_: None
    fd.fused_decode.launches = 0
    fd.fused_decode.launches_by_path = dict.fromkeys(fd.PATHS, 0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train(spec, cfg, tcfg, val_spec=val, max_steps=TRAIN_STEPS,
                      debug_level=0, device=device, log_fn=quiet)
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        resumed = train(spec, cfg, tcfg, val_spec=val,
                        max_steps=TRAIN_STEPS + RESUME_STEPS, debug_level=0,
                        device=device, restore_step="auto", log_fn=quiet)
    resume_s = time.perf_counter() - t0
    with open(os.path.join(train_dir, "best.json")) as f:
        best = json.load(f)

    # serve the last checkpoint on a few validation frames
    reader = val.readers()[0]
    frames = reader["depth"][:8]
    bbxs = pose_boxes(torch.from_numpy(reader["pose"][:8]), val.cfg,
                      val.fixed_bg_threshold)
    pred = Predictor.from_checkpoint(train_dir, cfg, val.cfg, max_batch=8,
                                     device=device)
    xyz = pred(frames, bbxs)
    served_err = np.linalg.norm((xyz - reader["pose"][:8]).reshape(
        8, -1, 3), axis=-1).max(axis=-1)
    launches = {"fused_decode": fd.fused_decode.launches,
                "fused_decode_by_path": dict(fd.fused_decode.launches_by_path)}
    resumed_to = resumed.step

    split, batch = step_split(resumed, spec, cfg, tcfg, device)
    prof = step_profile(resumed, batch, cfg, tcfg, device)
    secs = [r["sec_per_batch"] for r in rows if 2 <= r["step"] < TRAIN_STEPS]
    samples = tcfg.batch_size * tcfg.sub_batch
    losses = [r["loss"] for r in rows]
    row = {"phase": "train", "compute_dtype": dtype, "config": cfg.__dict__,
           "batch": [tcfg.sub_batch, tcfg.batch_size],
           "samples_per_step": samples, "steps": len(rows),
           "samples_per_s": samples / statistics.median(secs),
           "step_s": secs, "split_ms": split, "profile": prof,
           "max_memory_allocated_gib": peak / 2 ** 30,
           "loss_first": losses[0], "loss_last": losses[-1],
           "losses": losses, "train_s": train_s,
           "resumed_to_step": resumed_to, "resume_s": resume_s,
           "best": best, "served_frames": len(xyz),
           "served_max_joint_err_mm": served_err.tolist(),
           "launches": launches}
    emit(row)
    check(all(np.isfinite(losses)) and len(rows) == TRAIN_STEPS,
          f"train {dtype}: {len(rows)} steps, losses {losses}")
    check(resumed_to == TRAIN_STEPS + RESUME_STEPS,
          f"train {dtype}: resumed to step {resumed_to}")
    check(xyz.shape == (8, 3 * cfg.num_joint) and bool(np.isfinite(xyz).all()),
          f"train {dtype}: served xyz {xyz.shape} or non-finite")
    check(launches["fused_decode"] > 0
          and launches["fused_decode_by_path"]["strided"] == 0,
          f"train {dtype}: fused_decode launches {launches}")
    return row


def phase_train_overfit(spec, net_cfg: NetConfig, device, b: int = 8,
                        steps: int = 30):
    """A fixed batch of ``b`` crops at full width (float32, augmentation
    off) for ``steps`` steps: every loss finite, the last five below the
    first on average."""
    cfg = dataclasses.replace(net_cfg, compute_dtype="float32")
    tcfg = TrainConfig(batch_size=b, sub_batch=1, augment=False)
    state = create_train_state(cfg, tcfg, 1e6, device=device)
    batch = {k: v[None] for k, v in pose_crops(spec, b, cfg.input_hw,
                                               device).items()}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    losses = [float(train_step(state, batch, cfg, tcfg, gen)["loss"])
              for _ in range(steps)]
    last5 = float(np.mean(losses[-5:]))
    emit({"phase": "train_overfit", "batch": b, "steps": steps,
          "loss_first": losses[0], "loss_last": losses[-1],
          "last5_mean": last5, "loss_ratio": losses[-1] / losses[0],
          "losses": losses})
    check(all(np.isfinite(losses)), f"overfit: non-finite losses {losses}")
    check(last5 < losses[0], f"overfit: last five {last5} not below the "
                             f"first {losses[0]}")


def phase_train(net_cfg: NetConfig, device, root: str):
    """The training path on its own counts: data, one step card against
    CPU, ``train()`` in float32 and bfloat16 with resume and serving, and
    the overfit check, in ``root`` (the runs stay for the eval phase).
    Returns K1's launches in the phase."""
    spec, val = train_data(os.path.join(root, "data"))
    phase_train_card_vs_cpu(spec, net_cfg, device)
    runs = [phase_train_run(spec, val, net_cfg, dtype, root, device)
            for dtype in ("float32", "bfloat16")]
    phase_train_overfit(spec, net_cfg, device)
    by_path = dict.fromkeys(fd.PATHS, 0)
    for r in runs:
        for p, n in r["launches"]["fused_decode_by_path"].items():
            by_path[p] += n
    return {"fused_decode": sum(r["launches"]["fused_decode"] for r in runs),
            "fused_decode_by_path": by_path}


# --------------------------------------------------------------------------
# evaluation
# --------------------------------------------------------------------------

def eval_data(root: str, shards: int = 4, per_shard: int = 75):
    """Synthetic testing shards (the port's ``data/synthetic.py``), and the
    same frames stored with boxes around their poses (``uses_bbx``, as
    NYU's testing subset stores its frames), so that the test pipeline
    crops from the boxes."""
    t0 = time.perf_counter()
    spec = synthetic.make_spec("testing", directory=root, num_shards=shards,
                               samples_per_shard=per_shard, seed=SEED)
    boxed = []
    for path in spec.filenames:
        reader = ShardReader(path)
        bbxs = pose_boxes(torch.from_numpy(reader["pose"]), spec.cfg, 600.0)
        boxed.append(path.replace(os.sep + "testing" + os.sep,
                                  os.sep + "testing_boxed" + os.sep))
        with ShardWriter(boxed[-1]) as w:
            for d, p, n, b in zip(reader["depth"], reader["pose"],
                                  reader["name"], bbxs):
                w.add(d, p, str(n), b)
    boxed = dataclasses.replace(spec, filenames=boxed, uses_bbx=True)
    emit({"phase": "eval_data", "frames": spec.exact_num,
          "batch": EvalConfig().batch_size, "frame_hw": [240, 320],
          "joints": spec.jnt_num, "seconds": time.perf_counter() - t0})
    return spec, boxed


def run_test(spec, cfg: NetConfig, base_dir: str, device,
             ecfg: EvalConfig = EvalConfig(), net_name: str = "um_v1", **kw):
    """``train.loop.test`` into ``base_dir``'s run directory, which must
    hold no other result. Returns the report with the host seconds, the
    result file's names and xyz, and the error curve's rows."""
    t0 = time.perf_counter()
    report = test_driver(spec, cfg, TrainConfig(base_dir=base_dir), ecfg,
                         log_fn=lambda *_: None, device=device,
                         net_name=net_name, **kw)
    report = {**report, "seconds": time.perf_counter() - t0}
    run = os.path.join(base_dir, model_desc(spec.name, "training", cfg, True,
                                            net_name))
    (res,) = glob.glob(os.path.join(run, f"{spec.subset}-*-result.txt"))
    (err,) = glob.glob(os.path.join(run, f"{spec.subset}-*-result_error.txt"))
    names, xyz = read_result_file(res)
    with open(err) as f:
        curve = [line.split() for line in f]
    return report, names, xyz, curve


def eval_profile(spec, cfg: NetConfig, base_dir: str, device, top: int = 10,
                 **kw):
    """One more ``test()`` call under ``torch.profiler``: its host time,
    and the device's busy time and share of it (``device_time``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        report = run_test(spec, cfg, base_dir, device, **kw)[0]
    wall_ms = report["seconds"] * 1e3
    return {"wall_ms": wall_ms, **device_time(prof, wall_ms, top)}


def eval_heads(net, spec, n: int, device, **pipe_kw):
    """The decode's inputs for the first ``n`` frames of ``spec``, as
    ``test()`` computes them (``pipe_kw``: the test pipeline's
    host-preprocess options), on the CPU."""
    out_h, out_w = net.cfg.output_hw
    parts = []
    with torch.inference_mode():
        for batch in FramePipeline(spec, EvalConfig().batch_size,
                                   net.cfg.input_hw, device=device,
                                   **pipe_kw):
            normed = norm_dm(batch["dm"], batch["com"])
            outs = net(normed)
            tiny = method2_resize(normed, out_h, out_w)
            parts.append(tuple(t.cpu() for t in (
                outs["hm"][-1], outs["hm3"][-1], outs["um"][-1], tiny,
                batch["cfg"], batch["com"])))
            if sum(len(p[0]) for p in parts) >= n:
                break
    return tuple(torch.cat(ts)[:n] for ts in zip(*parts))


def decode_cancelled(heads, ecfg):
    """Per (frame, joint): whether the plain decode's mean shift cancelled
    on these heads (CPU tensors): a negative candidate weight, and the
    estimate outside the box of the candidates that carry weight. A
    positive weighted mean stays inside that box; a cancelled one divides by
    a sum near 0, which amplifies differences as small as the heads'
    rounding (seeded weights give such heads; PERF.md, PR 6)."""
    normed, cans, weights = decode.decode_plain(*heads, ecfg)
    live = (weights != 0)[..., None]
    lo = torch.where(live, cans, torch.inf).amin(dim=-2)
    hi = torch.where(live, cans, -torch.inf).amax(dim=-2)
    outside = ((normed < lo) | (normed > hi)).any(dim=-1)
    return (weights < 0).any(dim=-1) & outside


def eval_card_vs_cpu(xyz_card, xyz_cpu, variables, net_cfg: NetConfig, spec,
                     device):
    """The card's result lines against the CPU's, under ``card_vs_cpu``'s
    rule (a joint may be off by more than the decode's bound, plus the
    result file's rounding, only where the plain decode crosses a
    discontinuity between the two devices' heads) and one more cause: a
    mean shift that cancelled on either device's heads
    (``decode_cancelled``). The off joints are listed with their causes."""
    n = len(xyz_cpu)
    return joints_off(
        xyz_card[:n], xyz_cpu, XYZ_TOL_MM + RESULT_ROUNDING_MM,
        lambda: [eval_heads(from_flax(variables, net_cfg).to(d), spec, n, d)
                 for d in (device, "cpu")])


def joints_off(xyz_a, xyz_b, tol: float, heads_fn):
    """Result lines ``xyz_a`` against ``xyz_b``: the joints further apart
    than ``tol`` mm, each with its causes, from the two runs' heads
    (``heads_fn()``, CPU tensors, computed only when a joint is off): a
    discontinuity of the plain decode between them (``decode_flips``) or a
    mean shift that cancelled on either (``decode_cancelled``)."""
    n = len(xyz_b)
    gap = np.abs(xyz_a - xyz_b).reshape(n, -1, 3).max(axis=-1)
    off = gap > tol
    flips = cancelled = np.zeros_like(off)
    if off.any():
        heads = heads_fn()
        ecfg = EvalConfig()
        flips = decode_flips(heads[1], heads[0], ecfg).numpy()
        cancelled = (decode_cancelled(heads[0], ecfg)
                     | decode_cancelled(heads[1], ecfg)).numpy()
    return {"frames": n, "joints": int(off.size), "max_mm": float(gap.max()),
            "joints_off": int(off.sum()),
            "joints_at_a_decode_flip": int(flips.sum()),
            "joints_at_a_cancelled_mean_shift": int(cancelled.sum()),
            "joints_off_without_a_flip": int((off & ~flips).sum()),
            "joints_off_unexplained": int((off & ~flips & ~cancelled).sum()),
            "off": [[int(f), int(j), float(gap[f, j]), bool(flips[f, j]),
                     bool(cancelled[f, j])] for f, j in np.argwhere(off)]}


def phase_eval(variables, net_cfg: NetConfig, device, root: str,
               train_root: str, smi: str, n_cpu: int = 64):
    """The evaluation path on its own counts (see the module's docstring).
    Returns the kernels' launches in the phase."""
    t0 = time.perf_counter()
    spec, boxed = eval_data(os.path.join(root, "data"))
    payload = os.path.join(root, "params.msgpack")
    save_converted({**variables, "renorm_t": 0.0}, payload)
    fd.fused_decode.launches = 0
    fd.fused_decode.launches_by_path = dict.fromkeys(fd.PATHS, 0)
    k3.int8_gemm_requant.launches = 0
    k2.weighted_mean_shift_cuda.launches = 0
    dw.int8_dwconv_requant.launches = 0
    runs = {
        "init_params": run_test(spec, net_cfg, os.path.join(root, "card"),
                                device, init_params=payload),
        "boxes": run_test(boxed, net_cfg, os.path.join(root, "boxes"),
                          device, init_params=payload),
        "use_best": run_test(spec, net_cfg, os.path.join(train_root,
                                                         "float32"),
                             device, use_best=True)}
    launches = {"fused_decode": fd.fused_decode.launches,
                "fused_decode_by_path": dict(fd.fused_decode.launches_by_path),
                "int8_gemm_requant": k3.int8_gemm_requant.launches,
                "weighted_mean_shift": k2.weighted_mean_shift_cuda.launches,
                "int8_dwconv_requant": dw.int8_dwconv_requant.launches}
    prof = eval_profile(spec, net_cfg, os.path.join(root, "profiled"), device,
                        init_params=payload)

    want_names = [str(n).replace("/", "\\") for f in spec.filenames
                  for n in ShardReader(f)["name"]]
    cpu = run_test(dataclasses.replace(spec, exact_num=n_cpu), net_cfg,
                   os.path.join(root, "cpu"), "cpu", init_params=payload)
    vs_cpu = eval_card_vs_cpu(runs["init_params"][2], cpu[2], variables,
                              net_cfg, spec, device)
    batches = -(-spec.exact_num // EvalConfig().batch_size)
    row = {"phase": "eval", "frames": spec.exact_num,
           "batch": EvalConfig().batch_size, "batches": batches,
           "config": net_cfg.__dict__,
           **{name: {"frames_per_s": r[0]["fps"], "seconds": r[0]["seconds"],
                     "num_frames": r[0]["num_frames"],
                     "percentages": r[0]["percentages"],
                     "result_lines": len(r[1]), "curve_lines": len(r[3])}
              for name, r in runs.items()},
           "profile": prof, "card_vs_cpu": vs_cpu,
           "cpu_seconds": cpu[0]["seconds"],
           "launches": launches, "nvidia_smi": smi,
           "seconds": time.perf_counter() - t0}
    emit(row)
    for name, (report, names, xyz, curve) in runs.items():
        check(report["num_frames"] == spec.exact_num and names == want_names
              and xyz.shape == (spec.exact_num, 3 * net_cfg.num_joint)
              and bool(np.isfinite(xyz).all()),
              f"eval {name}: {len(names)} result lines, in shard order: "
              f"{names == want_names}, xyz {xyz.shape}")
        check(len(curve) == 17, f"eval {name}: {len(curve)} curve lines")
    check(cpu[1] == want_names[:n_cpu], "eval on the CPU: names")
    check(vs_cpu["joints_off_unexplained"] == 0,
          f"eval card vs CPU: {vs_cpu['joints_off_unexplained']} joints "
          f"off by more than {XYZ_TOL_MM + RESULT_ROUNDING_MM} mm with no "
          f"decode flip and no cancelled mean shift: {vs_cpu['off']}")
    check(launches["fused_decode"] == len(runs) * batches
          and launches["fused_decode_by_path"]["hm_pixels"]
          == launches["fused_decode"],
          f"eval: K1 launched {launches}, not once a batch on hm_pixels")
    check(launches["int8_gemm_requant"] == 0
          and launches["weighted_mean_shift"] == 0
          and launches["int8_dwconv_requant"] == 0,
          f"the evaluation path launched an off-path kernel: {launches}")
    return launches


# --------------------------------------------------------------------------
# the network variants
# --------------------------------------------------------------------------

VARIANTS = ("um_v1_lite", "um_v1_deconv")
VARIANT_TRAIN_STEPS = 6


def zero_counts():
    fd.fused_decode.launches = 0
    fd.fused_decode.launches_by_path = dict.fromkeys(fd.PATHS, 0)
    k3.int8_gemm_requant.launches = 0
    k2.weighted_mean_shift_cuda.launches = 0
    dw.int8_dwconv_requant.launches = 0
    k3.im2col_nhwc.cuda_calls = 0


def read_counts():
    return {"fused_decode": fd.fused_decode.launches,
            "fused_decode_by_path": dict(fd.fused_decode.launches_by_path),
            "int8_gemm_requant": k3.int8_gemm_requant.launches,
            "weighted_mean_shift": k2.weighted_mean_shift_cuda.launches,
            "int8_dwconv_requant": dw.int8_dwconv_requant.launches,
            "im2col_nhwc_cuda_calls": k3.im2col_nhwc.cuda_calls}


def serve_variant(variables, cfg: NetConfig, device, n_frames: int = 1024,
                  max_batch: int = 256, buckets=(1, 64, 256), reps: int = 3,
                  n_cpu: int = 8, n_calib: int = 64):
    """``Predictor`` serving of one variant in each dtype it supports
    (float32, bfloat16; ``um_v1_lite`` also calibrated and dynamic int8,
    ``um_v1_deconv`` dynamic int8), ``reps`` requests of ``n_frames``
    uint16 frames each (frames/s over the median), with the kernels' counts
    zeroed just before and read just after; then card against CPU
    predictors and the stages of a dispatch. Returns the counts."""
    module = cfg.net_module
    rng = np.random.default_rng(SEED + 2)
    distinct, boxes = hand_frames(rng, min(n_frames, 256))
    tile = -(-n_frames // len(distinct))
    frames = np.tile(distinct, (tile, 1, 1))[:n_frames]
    bbxs = np.tile(boxes, (tile, 1))[:n_frames]
    calib = hand_frames(np.random.default_rng(SEED + 4), n_calib)
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    modes = [("float32", f32, {}), ("bfloat16", bf16, {})]
    if module == "um_v1_lite":
        modes.append(("int8", bf16, dict(quantize=True, calibration=calib)))
    modes.append(("int8_dynamic", bf16, dict(quantize=True)))
    preds = {}
    for name, c, kw in modes:
        preds[name] = Predictor(variables, c, ICVL, max_batch=max_batch,
                                batch_buckets=buckets, device=device, **kw)
        preds[name].warmup()
    int8_net_ = preds["int8_dynamic"].net
    dw_convs = sum(1 for m in int8_net_.modules()
                   if isinstance(m, layers.ConvBR) and m.depthwise)
    k3_convs = sum(1 for m in int8_net_.modules()
                   if isinstance(m, layers.ConvBR)) - dw_convs
    residuals = sum(isinstance(m, layers.Residual)
                    for m in int8_net_.modules())

    zero_counts()
    secs, xyz = {}, {}
    for name in preds:
        secs[name] = []
        for _ in range(reps):
            t0 = time.perf_counter()
            xyz[name] = preds[name](frames, bbxs)
            secs[name].append(time.perf_counter() - t0)
    launches = read_counts()
    per_request = reps * -(-n_frames // max_batch)
    dispatches = len(preds) * per_request
    int8_dispatches = sum(n.startswith("int8") for n in preds) * per_request
    want = {"fused_decode": dispatches,
            "int8_gemm_requant": k3_convs * int8_dispatches,
            "weighted_mean_shift": 0,
            "int8_dwconv_requant": dw_convs * int8_dispatches,
            "im2col_nhwc_cuda_calls": 0}
    b = min(n_frames, max_batch)
    dev_frames = torch.from_numpy(frames[:b]).to(device)
    dev_bbxs = torch.from_numpy(bbxs[:b]).to(device)
    checks = {}
    n = min(n_cpu, n_frames)
    cpu_preds = [("float32", Predictor(variables, f32, ICVL, max_batch=n,
                                       device="cpu"))]
    if module == "um_v1_lite":
        qtree = {**quantize_weights(fold_batch_norm(variables,
                                                    cfg.bn_epsilon)),
                 "act_stats": act_stats_to_flax(preds["int8"].net)}
        cpu_preds.append(("int8", Predictor(qtree, bf16, ICVL, max_batch=n,
                                            device="cpu")))
    # dynamic int8: each layer's scale is its batch's max|x|, and a padded
    # dispatch repeats the last frame, so the card's bucket of n frames and
    # the CPU's batch of n quantize alike
    cpu_preds.append(("int8_dynamic", Predictor(
        variables, bf16, ICVL, max_batch=n, quantize=True, device="cpu")))
    for name, cpu in cpu_preds:
        checks[f"card_vs_cpu_{name}"] = card_vs_cpu(
            preds[name], cpu, frames[:n], bbxs[:n], dev_frames[:n],
            dev_bbxs[:n])
    if module == "um_v1_deconv":
        # how far the CPU's dynamic int8 heads move when only the
        # transposed convolution's rounding changes (2 frames)
        checks["cpu_int8_dynamic_deconv_rounding_head_err"] = (
            deconv_rounding_gap(cpu_preds[-1][1], frames[:2], bbxs[:2]))
    for name, pred in preds.items():
        heads = pred._heads(dev_frames, dev_bbxs)
        normed = decode.decode_poses(*heads, pred.ecfg)["normed"]
        checks[f"{name}_kernel_vs_plain_normed"] = (
            normed.cpu() - plain_on_cpu(heads)).abs().max().item()
    row = {"phase": "variants", "part": "serving", "net_module": module,
           "config": cfg.__dict__, "frames_per_request": n_frames,
           "frame_dtype": "uint16", "max_batch": max_batch,
           "frames_per_s": {d: n_frames / statistics.median(t)
                            for d, t in secs.items()},
           "request_s": secs, "dispatches": dispatches,
           "int8_dispatches": int8_dispatches,
           "int8_convs_per_forward": {"int8_gemm_requant": k3_convs,
                                      "int8_dwconv_requant": dw_convs},
           "residuals": residuals, "launches": launches,
           "expected_launches": want,
           "decode_input_strides": {
               name: [t.stride() for t in pred._heads(
                   pred._to_device(frames[:1]), pred._to_device(bbxs[:1]))[:4]]
               for name, pred in preds.items()},
           "checks": checks,
           "stages": {d: stage_ms(p, frames[:b], bbxs[:b])
                      for d, p in preds.items()}}
    emit(row)
    for name, out in xyz.items():
        check(out.shape == (n_frames, 3 * cfg.num_joint)
              and bool(np.isfinite(out).all()),
              f"variants {module} {name}: xyz {out.shape} or non-finite")
    for key, v in want.items():
        check(launches[key] == v, f"variants {module}: {key} launched "
                                  f"{launches[key]} times, expected {v}")
    # the int8 net's channels-last heads take the pixels path; the float
    # nets' paths follow the layouts cuDNN hands over (reported), none
    # strided
    paths = launches["fused_decode_by_path"]
    check(paths["pixels"] >= int8_dispatches and paths["strided"] == 0,
          f"variants {module}: fused_decode paths {paths} with "
          f"{int8_dispatches} int8 dispatches")
    check(dw_convs == (residuals if module == "um_v1_lite" else 0),
          f"variants {module}: {dw_convs} depthwise convolutions, "
          f"{residuals} residuals")
    for name in preds:
        err = checks[f"{name}_kernel_vs_plain_normed"]
        check(err <= K1_TOL, f"variants {module} {name}: K1 vs plain {err}")
    # every dynamic int8 lite layer is K3 or the depthwise kernel, each
    # equal to its plain version, so the lite net is held like the others;
    # the deconv net's transposed convolution runs in bfloat16 on cuDNN
    # and on the CPU's own convolution, whose roundings differ and move
    # the next layer's int8 steps: reported, not held
    held = [name for name, _ in cpu_preds
            if not (name == "int8_dynamic" and module == "um_v1_deconv")]
    for name in held:
        c = checks[f"card_vs_cpu_{name}"]
        check(c["joints_off_without_a_flip"] == 0,
              f"variants {module}: card vs CPU {name}: "
              f"{c['joints_off_without_a_flip']} joints off by more than "
              f"{XYZ_TOL_MM} mm with no decode flip")
    return launches


def deconv_rounding_gap(pred: Predictor, frames, bbxs) -> float:
    """The largest change of ``pred``'s heads (hm, hm3, um) when its
    transposed convolutions compute in float32 and round to their input's
    dtype once, against the default convolution of that dtype."""
    args = torch.from_numpy(frames), torch.from_numpy(bbxs)
    heads = pred._heads(*args)[:3]
    real = net_ops._ConvTranspose.forward
    net_ops._ConvTranspose.forward = (
        lambda self, x: real(self, x.float()).to(x.dtype))
    try:
        rounded = pred._heads(*args)[:3]
    finally:
        net_ops._ConvTranspose.forward = real
    return max((a.float() - b.float()).abs().max().item()
               for a, b in zip(heads, rounded))


def check_deconv_refuses_calibration(variables, cfg: NetConfig, device):
    """A calibrated int8 ``um_v1_deconv`` predictor must raise
    ``NotImplementedError`` (the JAX package's crashes)."""
    calib = hand_frames(np.random.default_rng(SEED + 4), 4)
    try:
        Predictor(variables, dataclasses.replace(cfg,
                                                 compute_dtype="bfloat16"),
                  ICVL, max_batch=4, quantize=True, calibration=calib,
                  device=device)
    except NotImplementedError as e:
        emit({"phase": "variants", "part": "calibrated_deconv_refused",
              "net_module": cfg.net_module, "message": str(e)})
        return
    raise RuntimeError("a calibrated int8 um_v1_deconv was served")


def train_variant(spec, val, cfg: NetConfig, root: str, device):
    """``train()`` in float32 at the ``TrainConfig`` defaults (40 x 5) for
    ``VARIANT_TRAIN_STEPS`` steps, validating on K1 every 3 and keeping the
    best: samples/s (median of steps 2 on), peak memory, K1's launches."""
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    tcfg = TrainConfig(base_dir=root, validate_every=3, keep_best=True,
                       summary_every=1)
    train_dir = os.path.join(root, model_desc(spec.name, spec.subset, cfg,
                                              tcfg.augment, cfg.net_module))
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train(spec, cfg, tcfg, val_spec=val, max_steps=VARIANT_TRAIN_STEPS,
              net_name=cfg.net_module, debug_level=0, device=device,
              log_fn=lambda *_: None)
    train_s = time.perf_counter() - t0
    launches = read_counts()
    with open(os.path.join(train_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    secs = [r["sec_per_batch"] for r in rows if r["step"] >= 2]
    losses = [r["loss"] for r in rows]
    samples = tcfg.batch_size * tcfg.sub_batch
    emit({"phase": "variants", "part": "train", "net_module": cfg.net_module,
          "config": cfg.__dict__, "batch": [tcfg.sub_batch, tcfg.batch_size],
          "steps": len(rows), "samples_per_s": samples / statistics.median(
              secs), "step_s": secs,
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated()
          / 2 ** 30, "loss_first": losses[0], "loss_last": losses[-1],
          "train_s": train_s, "launches": launches})
    check(len(rows) == VARIANT_TRAIN_STEPS and all(np.isfinite(losses)),
          f"variants {cfg.net_module} train: {len(rows)} steps, {losses}")
    check(launches["fused_decode"] > 0
          and launches["fused_decode_by_path"]["strided"] == 0
          and launches["int8_gemm_requant"] == 0
          and launches["int8_dwconv_requant"] == 0,
          f"variants {cfg.net_module} train: launches {launches}")
    return launches


def eval_variant(variables, spec, cfg: NetConfig, root: str, device):
    """One ``test()`` call on ``spec``'s frames (300) from a payload of the
    seeded weights, the run named by the variant."""
    os.makedirs(root, exist_ok=True)
    payload = os.path.join(root, f"{cfg.net_module}.msgpack")
    save_converted({**variables, "renorm_t": 0.0}, payload)
    zero_counts()
    report, names, xyz, curve = run_test(
        spec, cfg, os.path.join(root, cfg.net_module), device,
        net_name=cfg.net_module, init_params=payload)
    launches = read_counts()
    batches = -(-spec.exact_num // EvalConfig().batch_size)
    emit({"phase": "variants", "part": "test", "net_module": cfg.net_module,
          "frames": spec.exact_num, "frames_per_s": report["fps"],
          "seconds": report["seconds"], "result_lines": len(names),
          "curve_lines": len(curve), "launches": launches})
    check(len(names) == spec.exact_num and len(curve) == 17
          and xyz.shape == (spec.exact_num, 3 * cfg.num_joint)
          and bool(np.isfinite(xyz).all()),
          f"variants {cfg.net_module} test: {len(names)} lines, xyz "
          f"{xyz.shape}")
    check(launches["fused_decode"] == batches,
          f"variants {cfg.net_module} test: K1 launched "
          f"{launches['fused_decode']} times in {batches} batches")
    return launches


def phase_variants(trees, net_cfg: NetConfig, device, root: str,
                   train_root: str, eval_root: str):
    """``um_v1_lite`` and ``um_v1_deconv`` at ``net_cfg``'s widths: the
    model on the card against the CPU (float32), the calibrated int8 lite
    net step by step, serving in every dtype each supports, the calibrated
    deconv refusal, ``train()`` and ``test()``, from the seeded weights
    ``trees[module]``. Returns each kernel's launches over the phase's
    serving, training and test runs."""
    spec, val = train_data(os.path.join(train_root, "data"))
    test_spec = synthetic.make_spec(
        "testing", directory=os.path.join(eval_root, "data"), num_shards=4,
        samples_per_shard=75, seed=SEED)
    total = dict.fromkeys(("fused_decode", "int8_gemm_requant",
                           "weighted_mean_shift", "int8_dwconv_requant"), 0)
    k1_paths = dict.fromkeys(fd.PATHS, 0)
    for module in VARIANTS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(net_cfg, net_module=module)
        variables = trees[module]
        phase_model(variables, cfg, device)
        if module == "um_v1_lite":
            phase_model_int8(variables, cfg, device)
        else:
            check_deconv_refuses_calibration(variables, cfg, device)
        runs = [serve_variant(variables, cfg, device),
                train_variant(spec, val, cfg, os.path.join(root, "train"),
                              device),
                eval_variant(variables, test_spec, cfg,
                             os.path.join(root, "test"), device)]
        for counts in runs:
            for k in total:
                total[k] += counts[k]
            for p, v in counts["fused_decode_by_path"].items():
                k1_paths[p] += v
        torch.cuda.empty_cache()
        emit({"phase": "variants", "part": "done", "net_module": module,
              "seconds": time.perf_counter() - t0})
    return {**total, "fused_decode_by_path": k1_paths}

# --------------------------------------------------------------------------
# tooling: remat, the fused step, observability, host preprocess and wire
# --------------------------------------------------------------------------

TOOLING_TIMED_STEPS = 3
OBS_STEPS = 6


def first_batch(spec, cfg: NetConfig, tcfg: TrainConfig, device, seed=SEED,
                **kw):
    """The first batch of ``InputPipeline`` (``kw``: its host-preprocess
    options)."""
    pipe = InputPipeline(spec, tcfg.batch_size, tcfg.sub_batch, cfg.input_hw,
                         seed=seed, device=device, **kw)
    try:
        return next(iter(pipe))
    finally:
        pipe.close()


def check_on_card(tensors, what: str) -> None:
    for t in tensors:
        check(t.is_cuda, f"{what}: a tensor on {t.device}, not the card")


def timed_steps(state, batch, cfg: NetConfig, tcfg: TrainConfig, device,
                steps: int = TOOLING_TIMED_STEPS):
    """Samples/s (host clock, the device synchronised) and peak memory of
    ``steps`` train steps on one batch, after one more."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 8)
    train_step(state, batch, cfg, tcfg, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        train_step(state, batch, cfg, tcfg, gen)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return {"steps": steps, "step_ms": dt / steps * 1e3,
            "samples_per_s": steps * tcfg.batch_size * tcfg.sub_batch / dt,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def tooling_remat(spec, cfg: NetConfig, device):
    """One 40 x 5 step with and without ``remat`` from the same state and
    generator seed (augmentation on, dropout 0.5): the loss, each averaged
    gradient (relative norm), the moving statistics and the generator's
    state; then the peak memory and samples/s of each."""
    tcfg = TrainConfig()
    variables = init_train_variables(cfg, SEED)
    batch = first_batch(spec, cfg, tcfg, device)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = create_train_state(c, tcfg, 100.0, variables=variables,
                                   device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 9)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m = train_step(state, batch, c, tcfg, gen, with_grads=True)
        out[remat] = {
            "loss": float(m["loss"]),
            "grads": {k: g.double() for k, g in m["grads"].items()},
            "stats": {k: v.clone() for k, v in state.net.state_dict().items()
                      if k.endswith((".mean", ".var"))},
            "generator": gen.get_state(),
            "first_step_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "speed": timed_steps(state, batch, c, tcfg, device)}
        check_on_card(list(state.net.parameters()), "remat")
        del state, m
        torch.cuda.empty_cache()
    plain, remat = out[False], out[True]
    grad_rel = {k: float((remat["grads"][k] - g).norm() / (g.norm() + 1e-30))
                for k, g in plain["grads"].items()}
    worst = max(grad_rel, key=grad_rel.get)
    stats_excess = max(float(((remat["stats"][k] - v).abs()
                              - (STATS_ATOL + STATS_RTOL * v.abs())).max())
                       for k, v in plain["stats"].items())
    row = {"loss": plain["loss"], "loss_remat": remat["loss"],
           "loss_rel_diff": abs(remat["loss"] - plain["loss"])
           / abs(plain["loss"]),
           "max_grad_rel_norm": grad_rel[worst], "worst_param": worst,
           "grads_bit_equal": sum(v == 0.0 for v in grad_rel.values()),
           "params": len(grad_rel),
           "stats_max_abs_diff": max(
               float((remat["stats"][k] - v).abs().max())
               for k, v in plain["stats"].items()),
           "stats_max_excess_over_tol": stats_excess,
           "generator_state_equal": bool(torch.equal(plain["generator"],
                                                     remat["generator"])),
           "first_step_peak_gib": {"plain": plain["first_step_peak_gib"],
                                   "remat": remat["first_step_peak_gib"]},
           "timed": {"plain": plain["speed"], "remat": remat["speed"]}}
    check(np.isfinite(remat["loss"]) and row["loss_rel_diff"] <= LOSS_RTOL,
          f"remat: loss {remat['loss']} against {plain['loss']}")
    check(grad_rel[worst] <= GRAD_REL_TOL,
          f"remat: gradient of {worst} off by {grad_rel[worst]}")
    check(stats_excess <= 0.0, f"remat: moving statistics off by "
                               f"{stats_excess} over the tolerance")
    check(row["generator_state_equal"], "remat: the generator ends the step "
                                        "elsewhere than without remat")
    return row


def tooling_fused(spec, cfg: NetConfig, device, steps: int = 3):
    """``make_fused_train_step`` against the pipeline's crop
    (``preprocess_batch_from_pose`` on the card, the ``(sub, batch)``
    layout) followed by ``train_step``: ``steps`` steps at 40 x 5 from one
    state and generator seed on the same raw uint16 frames. Held: each
    step's loss (``LOSS_RTOL``) and the first step's averaged gradients
    (``GRAD_REL_TOL``, the card-vs-CPU limits: the card's backward sums in
    an order of its own, run to run). Reported: the parameters after the
    last step, each by the relative norm of its difference to how far it
    moved (Adam's first steps turn a near-zero gradient's sign into
    +-lr); then the fused step's samples/s."""
    tcfg = TrainConfig()
    sub, b = tcfg.sub_batch, tcfg.batch_size
    h, w = cfg.input_hw
    readers = spec.readers()
    frames = np.concatenate([r["depth"] for r in readers])
    take = np.arange(sub * b) % len(frames)       # repeats a small split
    frames = frames[take][..., None]
    poses = np.concatenate([r["pose"] for r in readers])[take]
    frames_d = torch.from_numpy(frames).to(device)
    poses_d = torch.from_numpy(poses.astype(np.float32)).to(device)
    cam = spec.cfg.as_array(device=device)
    variables = init_train_variables(cfg, SEED)
    two = create_train_state(cfg, tcfg, 100.0, variables=variables,
                             device=device)
    fused = create_train_state(cfg, tcfg, 100.0, variables=variables,
                               device=device)
    start = {k: p.detach().clone() for k, p in two.net.named_parameters()}
    gens = [torch.Generator(device=device) for _ in range(2)]
    for g in gens:
        g.manual_seed(SEED + 10)
    fn = make_fused_train_step(cfg, tcfg, spec.cfg, spec.fixed_bg_threshold)
    losses, grad_rel = [], None
    for i in range(steps):
        dm, pose, cfgs, coms = preprocess_batch_from_pose(
            frames_d, poses_d, cam, h, w, spec.fixed_bg_threshold)
        batch = {"dm": dm.reshape(sub, b, h, w, 1),
                 "pose": pose.reshape(sub, b, -1),
                 "cfg": cfgs.reshape(sub, b, 6),
                 "com": coms.reshape(sub, b, 3)}
        m_two = train_step(two, batch, cfg, tcfg, gens[0], with_grads=i == 0)
        m_fused = fn(fused, frames_d, poses_d, gens[1], with_grads=i == 0)
        losses.append((float(m_two["loss"]), float(m_fused["loss"])))
        if i == 0:
            grad_rel = {k: float((m_fused["grads"][k].double() - g.double())
                                 .norm() / (g.double().norm() + 1e-30))
                        for k, g in m_two["grads"].items()}
    worst_grad = max(grad_rel, key=grad_rel.get)
    loss_rel = max(abs(f - t) / abs(t) for t, f in losses)
    a = dict(two.net.named_parameters())
    with torch.no_grad():
        rel = {k: float((p - a[k]).norm()
                        / ((a[k] - start[k]).norm() + 1e-30))
               for k, p in fused.net.named_parameters()}
    worst = max(rel, key=rel.get)
    check_on_card(list(fused.net.parameters()), "fused step")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TOOLING_TIMED_STEPS):
        fn(fused, frames_d, poses_d, gens[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    speed = {"steps": TOOLING_TIMED_STEPS,
             "step_ms": dt / TOOLING_TIMED_STEPS * 1e3,
             "samples_per_s": TOOLING_TIMED_STEPS * sub * b / dt}
    row = {"steps": steps, "losses_pipeline_fused": losses,
           "max_loss_rel_diff": loss_rel,
           "first_step_max_grad_rel_norm": grad_rel[worst_grad],
           "first_step_worst_grad": worst_grad,
           "first_step_grads_bit_equal": sum(v == 0.0
                                             for v in grad_rel.values()),
           "params_bit_equal": sum(v == 0.0 for v in rel.values()),
           "params": len(rel), "max_param_rel_to_update": rel[worst],
           "worst_param": worst, "fused": speed}
    check(bool(np.isfinite(losses).all()) and loss_rel <= LOSS_RTOL,
          f"fused step: losses (pipeline, fused) {losses}")
    check(grad_rel[worst_grad] <= GRAD_REL_TOL,
          f"fused step: first step's gradient of {worst_grad} off by "
          f"{grad_rel[worst_grad]}")
    return row


def tooling_observability(spec, val, cfg: NetConfig, root: str, device):
    """``train()`` for ``OBS_STEPS`` steps with scalars every 2, histograms
    and validation every 3 and the profiler on step 2, ``debug_level=0``;
    its event file read back with the port's ``read_events`` (scalar,
    ``val/`` and histogram records, the histograms under the Flax key paths
    in order), its Chrome trace checked for kernel events; then
    ``_train_debug_images`` on the card into an event file of its own."""
    tcfg = TrainConfig(base_dir=os.path.join(root, "obs"), summary_every=2,
                       histogram_every=3, validate_every=3,
                       profile_dir=os.path.join(root, "trace"),
                       profile_start=2, profile_steps=1)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train(spec, cfg, tcfg, val_spec=val, max_steps=OBS_STEPS,
                      debug_level=0, device=device, log_fn=lambda *_: None)
    train_s = time.perf_counter() - t0
    run = os.path.join(tcfg.base_dir, model_desc(spec.name, spec.subset, cfg,
                                                 tcfg.augment))
    (path,) = glob.glob(os.path.join(run, "summary", "events.out.tfevents.*"))
    records = [(e["step"], v) for e in read_events(path)
               for v in e.get("values", [])]
    scalars = [(s, v["tag"]) for s, v in records if "simple_value" in v]
    hists = [(s, v["tag"]) for s, v in records if "histo" in v]
    flax_params = _tree_tags(to_flax(state.net)["params"])
    want_hist = [(s, f"{kind}/{tag}") for s in (0, 3)
                 for kind in ("params", "grads") for tag, _ in flax_params]
    metric_tags = ["grad_norm", "hm3_loss", "hm_loss", "loss", "param_norm",
                   "reg_loss", "um_loss", "learning_rate"]
    want_scalars = [(s, t) for s in range(0, OBS_STEPS)
                    for t in (metric_tags if s % 2 == 0 else [])
                    + (["val/max_joint_error"] if s % 3 == 0 else [])]
    (trace,) = glob.glob(os.path.join(tcfg.profile_dir, "*.json"))
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]

    events_dir = os.path.join(root, "debug_images")
    writer = EventWriter(events_dir)
    batch = first_batch(spec, cfg, TrainConfig(), device, seed=SEED + 12)
    check_on_card([batch["dm"]] + list(state.net.parameters()),
                  "debug images")
    _train_debug_images(_make_debug_fn(cfg), state, batch, writer, 0)
    writer.close()
    images = [v["tag"] for e in read_events(writer.path)
              for v in e.get("values", []) if "image" in v]
    row = {"train_s": train_s, "steps": OBS_STEPS, "records": len(records),
           "scalar_records": len(scalars), "histogram_records": len(hists),
           "histogram_tags_first": [t for _, t in hists[:3]],
           "trace_mb": os.path.getsize(trace) / 2 ** 20,
           "trace_events": len(events), "trace_kernel_events": len(kernels),
           "debug_image_tags": images}
    check(scalars == want_scalars,
          f"event file scalars {scalars[:12]}... against {want_scalars[:12]}")
    check(hists == want_hist, f"event file histograms: {len(hists)} "
                              f"records, {len(want_hist)} expected, first "
                              f"{hists[:2]} against {want_hist[:2]}")
    check(len(kernels) > 0, f"profiler trace {trace}: no kernel events "
                            f"among {len(events)}")
    want_images = [f"train/0/{t}" for t in (
        "dm", "hm_gt", "hm_est", "hm3_gt", "hm3_est", "um_xy_gt",
        "um_xy_est")]
    check(images == want_images, f"debug images: {images}")
    return row


def tooling_wire(spec, cfg: NetConfig, variables, root: str, device):
    """The host-preprocess paths at full size: the first 40 x 5 batch cropped
    on the host in float32 and on the uint16 wire against the card's crop
    (the wire within its bound, ``wire_error_bound``, of the host crop
    it encodes, the host's float32 crop within it of the card's, the wire
    within the sum of both of the card's); ``train()`` for 3
    steps in each against the device-crop run (first loss); ``test()`` on
    64 frames in each, whose result lines are compared with the device-crop
    run's (0.02 mm in float32, held; 0.05 mm on the wire, the JAX package's
    budget for it, reported), joints further off named with their decode
    flips."""
    tcfg = TrainConfig()
    crops = {"device": first_batch(spec, cfg, tcfg, device)}
    for wire in ("float32", "uint16"):
        crops[wire] = first_batch(spec, cfg, tcfg, device,
                                  host_preprocess=True, wire_dtype=wire)
        check_on_card(crops[wire].values(), f"host preprocess {wire}")
    bound = wire_error_bound(float(crops["float32"]["dm"].max()))
    gap = lambda a, b, k="dm": float((crops[a][k] - crops[b][k]).abs().max())
    # the wire against the host's float32 crop it encodes; the host's crop
    # against the card's (two devices' rounding); the wire against the card
    # within the sum of the two
    row = {"wire_bound_mm": bound,
           "crop_uint16_vs_float32_host_mm": gap("uint16", "float32"),
           "crop_float32_host_vs_card_mm": gap("float32", "device"),
           "crop_uint16_host_vs_card_mm": gap("uint16", "device"),
           "com_float32_host_vs_card_mm": gap("float32", "device", "com"),
           "background_equal": all(torch.equal(crops[w]["dm"] == 0,
                                               crops["device"]["dm"] == 0)
                                   for w in ("float32", "uint16"))}
    check(row["crop_uint16_vs_float32_host_mm"] <= bound
          and row["crop_float32_host_vs_card_mm"] <= bound
          and row["crop_uint16_host_vs_card_mm"]
          <= bound + row["crop_float32_host_vs_card_mm"]
          and row["background_equal"],
          f"host preprocess: crops against the wire's bound {bound}: {row}")
    losses = {}
    for name, kw in (("device", {}),
                     ("float32", dict(host_preprocess=True)),
                     ("uint16", dict(host_preprocess=True,
                                     wire_dtype="uint16"))):
        t = TrainConfig(base_dir=os.path.join(root, "wire", name),
                        summary_every=1, histogram_every=0, **kw)
        with contextlib.redirect_stdout(io.StringIO()):
            train(spec, cfg, t, max_steps=3, debug_level=0, device=device,
                  log_fn=lambda *_: None)
        run = os.path.join(t.base_dir, model_desc(spec.name, spec.subset,
                                                  cfg, t.augment))
        with open(os.path.join(run, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses[name] = [r["loss"] for r in rows]
        check(len(rows) == 3 and all(np.isfinite(losses[name])),
              f"train with {name} crop: {losses[name]}")
    row["train_losses"] = losses
    row["train_first_loss_rel_diff"] = {
        k: abs(losses[k][0] - losses["device"][0]) / abs(losses["device"][0])
        for k in ("float32", "uint16")}
    check(row["train_first_loss_rel_diff"]["float32"] <= LOSS_RTOL,
          f"train with the host crop: first loss {losses['float32'][0]} "
          f"against {losses['device'][0]}")

    test_spec = synthetic.make_spec(
        "testing", directory=os.path.join(root, "wire", "data"),
        num_shards=2, samples_per_shard=32, seed=SEED + 3)
    payload = os.path.join(root, "wire", "params.msgpack")
    save_converted({**variables, "renorm_t": 0.0}, payload)
    results = {}
    for name, kw in (("device", {}),
                     ("float32", dict(host_preprocess=True)),
                     ("uint16", dict(host_preprocess=True,
                                     wire_dtype="uint16"))):
        report, names, xyz, _ = run_test(
            test_spec, cfg, os.path.join(root, "wire", "test_" + name),
            device, ecfg=EvalConfig(batch_size=32, **kw),
            init_params=payload)
        results[name] = (names, xyz)
        row[f"test_{name}_frames_per_s"] = report["fps"]
    net = from_flax(variables, cfg)
    for name, tol in (("float32", XYZ_TOL_MM), ("uint16", 0.05)):
        names, xyz = results[name]
        check(names == results["device"][0],
              f"test with the {name} host crop: result names differ")
        pipe_kw = dict(host_preprocess=True, wire_dtype=name)
        report = joints_off(
            xyz, results["device"][1], tol + RESULT_ROUNDING_MM,
            lambda: [eval_heads(net.to(device), test_spec, len(xyz), device,
                                **kw) for kw in (pipe_kw, {})])
        row[f"test_{name}_vs_device_crop"] = report
        check(bool(np.isfinite(xyz).all()),
              f"test with the {name} host crop: non-finite xyz")
    # the float32 host crop is the card's crop up to the rounding of the two
    # devices; the wire moves each depth by up to its bound, which a random
    # net's ill-conditioned mean shifts amplify: reported, with the causes
    off = row["test_float32_vs_device_crop"]["joints_off_unexplained"]
    check(off == 0, f"test with the float32 host crop: {off} joints off "
                    f"with no decode flip and no cancelled mean shift: "
                    f"{row['test_float32_vs_device_crop']['off']}")
    return row


def phase_tooling(variables, net_cfg: NetConfig, device, root: str,
                  train_root: str):
    """The training tooling on counts of its own (see the module's
    docstring). Returns the kernels' launches in the phase."""
    t0 = time.perf_counter()
    spec, val = train_data(os.path.join(train_root, "data"))
    cfg = dataclasses.replace(net_cfg, compute_dtype="float32")
    zero_counts()
    row = {"phase": "tooling", "config": cfg.__dict__,
           "remat": tooling_remat(spec, cfg, device),
           "fused_step": tooling_fused(spec, cfg, device),
           "observability": tooling_observability(spec, val, cfg, root,
                                                  device),
           "wire": tooling_wire(spec, cfg, variables, root, device)}
    launches = read_counts()
    row.update(launches=launches, seconds=time.perf_counter() - t0)
    emit(row)
    check(launches["fused_decode"] > 0
          and launches["fused_decode_by_path"]["strided"] == 0
          and launches["int8_gemm_requant"] == 0
          and launches["weighted_mean_shift"] == 0
          and launches["int8_dwconv_requant"] == 0,
          f"tooling: launches {launches}")
    return launches


# --------------------------------------------------------------------------
# the serving daemon
# --------------------------------------------------------------------------

def serve_clients(server, frames, bbxs, n_clients: int):
    """``n_clients`` concurrent ``Client``s, each sending its share of the
    frames pipelined (all submitted before any answer is read). Returns the
    answers in frame order and the host seconds."""
    per = len(frames) // n_clients
    out, errs = [None] * n_clients, []

    def one(i):
        try:
            with Client(server.address) as c:
                out[i] = c.predict_batch(frames[i * per:(i + 1) * per],
                                         bbxs[i * per:(i + 1) * per])
        except Exception as exc:
            errs.append((i, repr(exc)))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    dt = time.perf_counter() - t0
    check(not errs and all(o is not None for o in out),
          f"daemon clients failed: {errs}")
    return np.concatenate(out), dt


def flood(server, frame, bbx, n: int):
    """One client submits ``n`` requests before reading any: the answers
    and ``overloaded`` sheds, and the server's stats."""
    ok = shed = 0
    with Client(server.address) as c:
        for i in range(n):
            c.submit(frame, bbx, rid=i)
        for _ in range(n):
            resp = c.recv()
            if resp.get("error") == "overloaded":
                shed += 1
            else:
                check("xyz" in resp, f"daemon flood: reply {resp}")
                ok += 1
        st = c.stats()
    return {"requests": n, "answered": ok, "shed": shed, "stats": st}


class TimedPredictor:
    """A predictor's ``_dispatch`` with the host seconds of each call kept
    (the batcher's time to stack, pin, copy and issue a batch); with
    ``null``, a predictor that does no work and answers zeros, so that the
    daemon's own host path is all that is timed."""

    def __init__(self, pred: Predictor, null: bool = False):
        self.pred, self.null = pred, null
        self.max_batch, self.camera = pred.max_batch, pred.camera
        self.accepts_u16 = pred.accepts_u16
        self.host_s = []

    def _dispatch(self, frames, bbxs):
        t0 = time.perf_counter()
        out = (np.zeros((len(frames), 3 * self.pred.net_cfg.num_joint),
                        np.float32) if self.null
               else self.pred._dispatch(frames, bbxs))
        self.host_s.append(time.perf_counter() - t0)
        return out


def socket_address(root: str, name: str) -> str:
    """A Unix socket under ``root``, or in the abstract namespace where that
    path would pass the 107 bytes a socket's path may have."""
    path = os.path.join(root, name + ".sock")
    return path if len(path) < 100 else f"\0densereg_{os.getpid()}_{name}"


def phase_daemon(variables, net_cfg: NetConfig, device, root: str,
                 n_clients: int = 4, per_client: int = 1024,
                 max_batch: int = 256, n_calib: int = 64):
    """The serving daemon (``densereg_torch.serve``) on a Unix socket over
    the float32 ``Predictor`` and over the calibrated int8 one, with
    ``n_clients`` concurrent clients of ``per_client`` uint16 frames each,
    on counts of their own; the answers against a direct ``Predictor`` call
    on the same frames; then a flood against a bounded queue. Returns the
    kernels' launches of the two servers."""
    t0 = time.perf_counter()
    n = n_clients * per_client
    distinct, boxes = hand_frames(np.random.default_rng(SEED + 11),
                                  min(n, 256))
    tile = -(-n // len(distinct))
    frames = np.tile(distinct, (tile, 1, 1))[:n]
    bbxs = np.tile(boxes, (tile, 1))[:n]
    calib = hand_frames(np.random.default_rng(SEED + 4), n_calib)
    preds = {
        "float32": Predictor(variables, dataclasses.replace(
            net_cfg, compute_dtype="float32"), ICVL, max_batch=max_batch,
            device=device),
        "int8": Predictor(variables, dataclasses.replace(
            net_cfg, compute_dtype="bfloat16"), ICVL, max_batch=max_batch,
            quantize=True, calibration=calib, device=device)}
    direct, direct_fps = {}, {}
    for name, pred in preds.items():
        check(pred.device.type == "cuda", f"daemon {name}: predictor on "
                                          f"{pred.device}")
        pred.warmup(with_u16=True)
        t1 = time.perf_counter()
        direct[name] = pred(frames, bbxs)
        direct_fps[name] = n / (time.perf_counter() - t1)
    convs = sum(isinstance(m, layers.ConvBR)
                for m in preds["int8"].net.modules())

    zero_counts()
    rows = {}
    for name, pred in preds.items():
        timed = TimedPredictor(pred)
        # a queue that holds every request: this run answers them all
        with Server(timed, socket_address(root, name), max_queue=n) as srv:
            got, dt = serve_clients(srv, frames, bbxs, n_clients)
            st = srv.stats()
        gap = np.abs(got - direct[name]).reshape(n, -1, 3).max(axis=-1)
        flips = np.argwhere(gap > 1e-3)
        rows[name] = {"frames_per_s": n / dt, "seconds": dt,
                      "stats": st,
                      "direct_frames_per_s": direct_fps[name],
                      "dispatch_host_ms": statistics.mean(timed.host_s) * 1e3,
                      "max_mm_from_direct": float(gap.max()),
                      "decode_flips": len(flips),
                      "decode_flip_joints": flips[:20].tolist()}
    launches = read_counts()
    # the daemon's own ceiling: the same clients against a predictor that
    # does no work
    null = TimedPredictor(preds["float32"], null=True)
    with Server(null, socket_address(root, "null"), max_queue=n) as srv:
        _, dt = serve_clients(srv, frames, bbxs, n_clients)
        host_ceiling = {"frames_per_s": n / dt,
                        "batches": srv.stats()["batches"],
                        "dispatch_host_ms": statistics.mean(null.host_s) * 1e3}
    batches = {name: r["stats"]["batches"] for name, r in rows.items()}
    flood_row = None
    with Server(preds["float32"], socket_address(root, "flood"),
                max_queue=max_batch) as srv:
        flood_row = flood(srv, frames[0], bbxs[0], 4 * max_batch)
    row = {"phase": "daemon", "config": net_cfg.__dict__,
           "clients": n_clients, "frames_per_client": per_client,
           "frame_dtype": "uint16", "max_batch": max_batch, **rows,
           "int8_convs_per_forward": convs, "host_ceiling": host_ceiling,
           "flood": flood_row,
           "launches": launches, "seconds": time.perf_counter() - t0}
    emit(row)
    for name, r in rows.items():
        st = r["stats"]
        check(st["errors"] == 0 and st["requests"] == n
              and st["responses"] == n and st["sheds"] == 0,
              f"daemon {name}: stats {st}")
    check(launches["fused_decode"] == sum(batches.values())
          and launches["fused_decode_by_path"]["strided"] == 0,
          f"daemon: K1 launched {launches['fused_decode']} times for "
          f"{batches} batches")
    check(launches["int8_gemm_requant"] == convs * batches["int8"],
          f"daemon: K3 launched {launches['int8_gemm_requant']} times, "
          f"{convs} a forward x {batches['int8']} int8 batches expected")
    check(launches["weighted_mean_shift"] == 0
          and launches["int8_dwconv_requant"] == 0
          and launches["im2col_nhwc_cuda_calls"] == 0,
          f"daemon: off-path launches {launches}")
    fst = flood_row["stats"]
    check(fst["errors"] == 0
          and flood_row["answered"] + flood_row["shed"] == 4 * max_batch
          and fst["responses"] == flood_row["answered"]
          and fst["sheds"] == flood_row["shed"],
          f"daemon flood: {flood_row}")
    return launches


def add_counts(acc: dict, counts: dict) -> None:
    """``acc += counts`` for two dicts of ``read_counts``' form."""
    for k, v in counts.items():
        if isinstance(v, dict):
            d = acc.setdefault(k, dict.fromkeys(v, 0))
            for p, n in v.items():
                d[p] += n
        else:
            acc[k] = acc.get(k, 0) + v


@contextlib.contextmanager
def counted(acc: dict):
    """Add the kernels' launches made inside the block to ``acc``: the
    counts are set to 0 on entry and read on exit, so that launches made
    outside, by the live predictors this phase compares with, stay out of
    ``acc``."""
    zero_counts()
    yield
    add_counts(acc, read_counts())


def kernel_names_in(fn, names, want=None, tries: int = 3):
    """How many times each CUDA kernel whose name holds one of ``names``
    ran in one call of ``fn``, by ``torch.profiler``'s kernel records (a
    plain-version program launches none of them). The profiler now and
    then loses records (``device_ms``): a count other than ``want`` is
    taken again, up to ``tries`` calls in all."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        found = {n: sum(n in k for k in kernels) for n in names}
        if want is None or found == want:
            break
    return found


EXPORT_KERNELS = ("fused_decode_kernel", "k3_kernel")


def phase_export(variables, net_cfg: NetConfig, device, root: str,
                 n_frames: int = 1024, max_batch: int = 256,
                 n_calib: int = 64):
    """Export artifacts (``densereg_torch.export``) at full width: the
    float32 (TF32 off), bfloat16 and calibrated int8 ``Predictor`` at
    ``max_batch`` exported on the card (float32 and uint16 entries), loaded
    back and held against the live predictor on the same uint16 requests
    (the largest joint gap, mm) and one float32 dispatch; K1's and K3's
    launches inside the loaded programs, by the counters and by the
    profiler's kernel names; the artifact's MB, export and load seconds,
    frames/s of the loaded programs against the live predictor's (in turns:
    live, loaded, loaded, live); then one ``Server`` run on the int8
    artifact. Returns the kernels' launches made by the loaded programs."""
    from densereg_torch.export import export_predictor, load_exported

    t0 = time.perf_counter()
    frames, bbxs = hand_frames(np.random.default_rng(SEED + 13), n_frames)
    calib = hand_frames(np.random.default_rng(SEED + 4), n_calib)
    bf16 = dataclasses.replace(net_cfg, compute_dtype="bfloat16")
    kinds = {
        "float32": (dataclasses.replace(net_cfg, compute_dtype="float32"),
                    {}),
        "bfloat16": (bf16, {}),
        "int8": (bf16, {"quantize": True, "calibration": calib})}
    dispatches = -(-n_frames // max_batch)
    acc, rows, loaded_int8 = {}, {}, None
    for name, (cfg, kw) in kinds.items():
        pred = Predictor(variables, cfg, ICVL, max_batch=max_batch,
                         device=device, **kw)
        pred.warmup(with_u16=True)
        path = os.path.join(root, f"{name}.pt2")
        t1 = time.perf_counter()
        export_predictor(pred, path)
        export_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        loaded = load_exported(path)
        load_s = time.perf_counter() - t1
        check(loaded.device.type == "cuda" and loaded.accepts_u16
              and loaded.batch_buckets == (max_batch,),
              f"export {name}: loaded {loaded.device}, buckets "
              f"{loaded.batch_buckets}")
        with counted(acc):
            loaded.warmup(with_u16=True)
        want = pred(frames, bbxs)
        mine = {}
        with counted(mine):
            got = loaded(frames, bbxs)
        gap = float(np.abs(got - want).max())
        f32 = frames[:max_batch].astype(np.float32)
        with counted(mine):
            got32 = loaded(f32, bbxs[:max_batch])
        gap32 = float(np.abs(got32 - pred(f32, bbxs[:max_batch])).max())
        convs = (sum(isinstance(m, layers.ConvBR)
                     for m in pred.net.modules()) if name == "int8" else 0)
        want_k3 = convs * (dispatches + 1)
        check(mine["fused_decode"] == dispatches + 1
              and mine["int8_gemm_requant"] == want_k3
              and mine["im2col_nhwc_cuda_calls"] == 0,
              f"export {name}: the loaded program launched {mine}, expected "
              f"K1 {dispatches + 1} and K3 {want_k3}")
        add_counts(acc, mine)
        expect = {"fused_decode_kernel": 1, "k3_kernel": convs}
        with counted(acc):
            names = kernel_names_in(
                lambda: loaded._dispatch(frames[:max_batch, ..., None],
                                         bbxs[:max_batch]).cpu(),
                EXPORT_KERNELS, expect)
        check(names == expect,
              f"export {name}: the profiler saw {names} in one dispatch of "
              f"the loaded program, expected 1 K1 and {convs} K3")
        fps = {"live": [], "loaded": []}
        for who in ("live", "loaded", "loaded", "live"):
            fn = pred if who == "live" else loaded
            ctx = counted(acc) if who == "loaded" else contextlib.nullcontext()
            with ctx:
                t1 = time.perf_counter()
                fn(frames, bbxs)
                fps[who].append(n_frames / (time.perf_counter() - t1))
        rows[name] = {
            "artifact_mb": os.path.getsize(path) / 2 ** 20,
            "export_s": export_s, "load_s": load_s,
            "max_joint_gap_mm": gap, "max_joint_gap_mm_f32_entry": gap32,
            "launches_checked": mine, "profiler_kernels_one_dispatch": names,
            "frames_per_s_loaded": statistics.mean(fps["loaded"]),
            "frames_per_s_live": statistics.mean(fps["live"]),
            "frames_per_s_runs": fps}
        check(np.isfinite(got).all() and got.shape == (n_frames,
                                                      3 * cfg.num_joint),
              f"export {name}: output {got.shape}")
        check(gap <= XYZ_TOL_MM and gap32 <= XYZ_TOL_MM,
              f"export {name}: loaded program {gap} / {gap32} mm from the "
              f"live predictor")
        if name == "int8":
            loaded_int8 = loaded
        del pred
        torch.cuda.empty_cache()
    # one daemon run on the loaded int8 artifact
    with counted(acc):
        with Server(loaded_int8, socket_address(root, "export"),
                    max_queue=n_frames) as srv:
            served, dt = serve_clients(srv, frames, bbxs, 4)
            st = srv.stats()
        direct = loaded_int8(frames, bbxs)
    server_gap = float(np.abs(served - direct).max())
    row = {"phase": "export", "config": net_cfg.__dict__,
           "max_batch": max_batch, "frames": n_frames,
           "frame_dtype": "uint16", **rows,
           "server_int8": {"frames_per_s": n_frames / dt, "stats": st,
                           "max_mm_from_direct": server_gap},
           "launches": acc, "seconds": time.perf_counter() - t0}
    emit(row)
    check(st["errors"] == 0 and st["responses"] == n_frames
          and server_gap <= 1e-3,
          f"export: the server on the int8 artifact: {st}, {server_gap} mm")
    check(acc["weighted_mean_shift"] == 0 and acc["int8_dwconv_requant"] == 0
          and acc["fused_decode_by_path"]["strided"] == 0,
          f"export: off-path launches {acc}")
    return acc


def phase_multigpu(variables, net_cfg: NetConfig, root: str, train_root: str,
                   sub: int = 2, b: int = 4, n_frames: int = 1024,
                   max_batch: int = 256, n_calib: int = 64,
                   device: str = "cuda", backend: str = "nccl"):
    """Data parallelism on a one-rank NCCL group (``parallel``): one
    synchronized training step (renorm moments and gradients all-reduced
    over the group) against the plain step from the same weights on the
    same batch, full width, float32, dropout 0, cuDNN's deterministic
    algorithms (the loss and the largest parameter, gradient and
    moving-statistic gaps); ``Predictor(mesh=...)`` against ``Predictor``
    in float32 and calibrated int8 on 1,024 uint16 frames. Returns the
    kernels' launches of the mesh predictors. (``device``, ``backend``: a
    CPU rehearsal passes ``"cpu"``, ``"gloo"``.)"""
    import socket as socket_mod

    import torch.distributed as dist

    from densereg_torch.models import sync_batch_renorm
    from densereg_torch.parallel import initialize_distributed, make_mesh
    from densereg_torch.utils.device import topology_report

    t0 = time.perf_counter()
    with socket_mod.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multi = initialize_distributed(f"localhost:{port}", 1, 0,
                                   backend=backend)
    deterministic = torch.backends.cudnn.deterministic
    try:
        mesh = make_mesh(devices=None if device == "cuda" else [device])
        check(not multi and dist.get_backend() == backend
              and mesh.world_size == 1 and mesh.size == 1,
              f"multigpu: mesh {mesh}, backend {dist.get_backend()}")
        spec, _ = train_data(os.path.join(train_root, "data"))
        cfg = dataclasses.replace(net_cfg, dropout_rate=0.0,
                                  compute_dtype="float32")
        tcfg = TrainConfig(batch_size=b, sub_batch=sub, augment=False)
        init = init_train_variables(cfg, SEED)
        crops = pose_crops(spec, sub * b, cfg.input_hw, mesh.devices[0])
        batch = {k: v.reshape((sub, b) + tuple(v.shape[1:]))
                 for k, v in crops.items()}
        out = {}
        torch.backends.cudnn.deterministic = True
        for kind in ("plain", "synced"):
            state = create_train_state(cfg, tcfg, 100.0, variables=init,
                                       device=mesh.devices[0])
            group = None
            if kind == "synced":
                group = mesh.group
                sync_batch_renorm(state.net, group)
            m = train_step(state, batch, cfg, tcfg, with_grads=True,
                           group=group)
            out[kind] = (float(m["loss"]),
                         {k: g.double() for k, g in m["grads"].items()},
                         {k: v.double() for k, v in
                          state.net.state_dict().items()})
        (l_p, g_p, s_p), (l_s, g_s, s_s) = out["plain"], out["synced"]
        grad_rel = max(float((g_s[k] - g).norm() / (g.norm() + 1e-30))
                       for k, g in g_p.items())
        param_gap = max(float((s_s[k] - v).abs().max())
                        for k, v in s_p.items())
        step_row = {"loss_plain": l_p, "loss_synced": l_s,
                    "loss_rel_diff": abs(l_s - l_p) / abs(l_p),
                    "max_grad_rel_norm": grad_rel,
                    "max_param_and_stats_gap": param_gap}
        check(step_row["loss_rel_diff"] <= LOSS_RTOL
              and grad_rel <= GRAD_REL_TOL
              and param_gap <= STATS_ATOL,
              f"multigpu: synchronized step off the plain step: {step_row}")
        torch.backends.cudnn.deterministic = deterministic
        del out, batch
        torch.cuda.empty_cache()

        frames, bbxs = hand_frames(np.random.default_rng(SEED + 17),
                                   n_frames)
        calib = hand_frames(np.random.default_rng(SEED + 4), n_calib)
        bf16 = dataclasses.replace(net_cfg, compute_dtype="bfloat16")
        acc, serve_rows = {}, {}
        for name, (pcfg, kw) in {
                "float32": (dataclasses.replace(
                    net_cfg, compute_dtype="float32"), {}),
                "int8": (bf16, {"quantize": True,
                                "calibration": calib})}.items():
            plain = Predictor(variables, pcfg, ICVL, max_batch=max_batch,
                              device=device, **kw)
            meshed = Predictor(variables, pcfg, ICVL, max_batch=max_batch,
                               mesh=mesh, **kw)
            meshed.warmup(with_u16=False)
            want = plain(frames, bbxs)
            with counted(acc):
                t1 = time.perf_counter()
                got = meshed(frames, bbxs)
                dt = time.perf_counter() - t1
            gap = float(np.abs(got - want).max())
            serve_rows[name] = {"max_joint_gap_mm": gap,
                                "frames_per_s_mesh": n_frames / dt}
            check(np.isfinite(got).all() and gap <= XYZ_TOL_MM,
                  f"multigpu: Predictor(mesh) {name} {gap} mm off")
            del plain, meshed
            torch.cuda.empty_cache()
        row = {"phase": "multigpu", "backend": backend,
               "world_size": mesh.world_size, "mesh_size": mesh.size,
               "topology": topology_report(),
               "step": {"config": cfg.__dict__, "batch": [sub, b],
                        **step_row},
               "predictor_mesh": serve_rows, "launches": acc,
               "seconds": time.perf_counter() - t0}
        emit(row)
        dispatches = -(-n_frames // max_batch)
        check(acc["fused_decode"] == 2 * dispatches
              and acc["int8_gemm_requant"] > 0
              and acc["weighted_mean_shift"] == 0
              and acc["int8_dwconv_requant"] == 0,
              f"multigpu: the mesh predictors launched {acc}")
        return acc
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    smi = gpu_name_and_power()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device_count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    libs = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})

    # float32 everywhere below means float32: cuDNN would use TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = phase_kernel("cuda")
    net_cfg = NetConfig()
    variables = init_variables(net_cfg, seed=SEED)
    _, k3_total = phase_kernel_int8(variables, net_cfg, "cuda")
    trees = {m: init_variables(dataclasses.replace(net_cfg, net_module=m),
                               seed=SEED) for m in VARIANTS}
    dw_totals = phase_kernel_dwconv(
        trees["um_v1_lite"],
        dataclasses.replace(net_cfg, net_module="um_v1_lite"), "cuda")
    dw_total = dw_totals["calibrated"]
    phase_model(variables, net_cfg, "cuda")
    phase_model_int8(variables, net_cfg, "cuda")
    launches, preds, frames, bbxs = phase_serving(variables, "cuda", net_cfg)
    b = 256
    k2_row = phase_kernel_meanshift(preds["float32"]._heads(
        torch.from_numpy(frames[:b]).cuda(), torch.from_numpy(bbxs[:b]).cuda()),
        preds["float32"].ecfg, "cuda")
    del preds
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="densereg_") as root:
        # the training path, on counts of its own
        k3.int8_gemm_requant.launches = 0
        k2.weighted_mean_shift_cuda.launches = 0
        dw.int8_dwconv_requant.launches = 0
        train_root = os.path.join(root, "train")
        train_launches = phase_train(net_cfg, "cuda", train_root)
        train_launches.update(
            int8_gemm_requant=k3.int8_gemm_requant.launches,
            weighted_mean_shift=k2.weighted_mean_shift_cuda.launches,
            int8_dwconv_requant=dw.int8_dwconv_requant.launches)
        check(train_launches["int8_gemm_requant"] == 0
              and train_launches["weighted_mean_shift"] == 0
              and train_launches["int8_dwconv_requant"] == 0,
              f"the training path launched an off-path kernel: "
              f"{train_launches}")
        # the evaluation path, on counts of its own
        eval_launches = phase_eval(variables, net_cfg, "cuda",
                                   os.path.join(root, "eval"), train_root,
                                   smi)
        # the network variants, on counts of their own
        variants_launches = phase_variants(
            trees, net_cfg, "cuda", os.path.join(root, "variants"),
            train_root, os.path.join(root, "eval"))
        check(variants_launches["int8_dwconv_requant"] > 0
              and variants_launches["weighted_mean_shift"] == 0,
              f"the variants' paths launched {variants_launches}")
        # the training tooling and the serving daemon, on counts of their own
        tooling_launches = phase_tooling(
            variables, net_cfg, "cuda", os.path.join(root, "tooling"),
            train_root)
        daemon_launches = phase_daemon(variables, net_cfg, "cuda", root)
        # the export artifacts and the data-parallel path, on counts of
        # their own
        export_launches = phase_export(variables, net_cfg, "cuda", root)
        multigpu_launches = phase_multigpu(variables, net_cfg, root,
                                           train_root)

    # the serving bucket as the float nets (hm_pixels) and the int8 net
    # (pixels) hand it over
    main_row = rows[0]
    int8_row = next(r for r in rows if r["layout"] == "nhwc")
    emit({"kernels": [{
        "name": "fused_decode", "route": "cuda",
        "source": "densereg_torch/csrc/fused_decode.cu",
        "includes": ["densereg_torch/csrc/vote_meanshift.cuh"],
        "replaces": "densereg_tpu/ops/fused_decode.py:39",
        "launches": launches["fused_decode"],
        "launches_by_path": launches["fused_decode_by_path"],
        "train_launches": train_launches["fused_decode"],
        "train_launches_by_path": train_launches["fused_decode_by_path"],
        "eval_launches": eval_launches["fused_decode"],
        "eval_launches_by_path": eval_launches["fused_decode_by_path"],
        "variants_launches": variants_launches["fused_decode"],
        "variants_launches_by_path": variants_launches["fused_decode_by_path"],
        "tooling_launches": tooling_launches["fused_decode"],
        "tooling_launches_by_path": tooling_launches["fused_decode_by_path"],
        "daemon_launches": daemon_launches["fused_decode"],
        "daemon_launches_by_path": daemon_launches["fused_decode_by_path"],
        "export_launches": export_launches["fused_decode"],
        "export_launches_by_path": export_launches["fused_decode_by_path"],
        "multigpu_launches": multigpu_launches["fused_decode"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "device_ms": main_row["device_ms"],
        "device_ms_channels_last": int8_row["device_ms"],
        "host_us": main_row["host_us"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        # one forward of the int8 net at batch 256: every call, summed. The
        # function is the convolution: its bound reads each activation
        # once, and the library yardstick builds the im2col it starts from
        "name": "int8_gemm_requant", "route": "cuda",
        "source": "densereg_torch/csrc/int8_gemm.cu",
        "replaces": "densereg_tpu/ops/int8_gemm.py:35",
        "launches": launches["int8_gemm_requant"],
        "train_launches": train_launches["int8_gemm_requant"],
        "eval_launches": eval_launches["int8_gemm_requant"],
        "eval_launches_by_path": None,
        "variants_launches": variants_launches["int8_gemm_requant"],
        "tooling_launches": tooling_launches["int8_gemm_requant"],
        "daemon_launches": daemon_launches["int8_gemm_requant"],
        "export_launches": export_launches["int8_gemm_requant"],
        "multigpu_launches": multigpu_launches["int8_gemm_requant"],
        "max_abs_err": k3_total["max_abs_err"],
        "ms": k3_total["ms"], "device_ms": k3_total["device_ms"],
        "plain_ms": k3_total["plain_ms"],
        "bound_ms": k3_total["conv_bound_ms"],
        "bound_by": k3_total["conv_bound_by"],
        "im2col_bound_ms": k3_total["bound_ms"],
        "library_ms": k3_total["library_ms"] + k3_total["im2col_ms"]}, {
        "name": "weighted_mean_shift", "route": "cuda",
        "source": "densereg_torch/csrc/meanshift.cu",
        "includes": ["densereg_torch/csrc/vote_meanshift.cuh"],
        "replaces": "densereg_tpu/ops/meanshift_pallas.py:33",
        "launches": launches["weighted_mean_shift"],
        "train_launches": train_launches["weighted_mean_shift"],
        "eval_launches": eval_launches["weighted_mean_shift"],
        "eval_launches_by_path": None,
        "variants_launches": variants_launches["weighted_mean_shift"],
        "tooling_launches": tooling_launches["weighted_mean_shift"],
        "daemon_launches": daemon_launches["weighted_mean_shift"],
        "export_launches": export_launches["weighted_mean_shift"],
        "multigpu_launches": multigpu_launches["weighted_mean_shift"],
        "max_abs_err": k2_row["max_abs_err"],
        "ms": k2_row["ms"], "device_ms": k2_row["device_ms"],
        "host_us": k2_row["host_us"], "plain_ms": k2_row["plain_ms"],
        "bound_ms": k2_row["bound_ms"], "bound_by": k2_row["bound_by"],
        "library_ms": None}, {
        # the port's own kernel (no Pallas counterpart: XLA's grouped int8
        # convolution in the JAX package); one forward of the calibrated
        # int8 um_v1_lite net at batch 256, every call summed. Its main
        # path is the variants phase: "launches" counts that phase
        "name": "int8_dwconv_requant", "route": "cuda",
        "source": "densereg_torch/csrc/int8_dwconv.cu",
        "includes": ["densereg_torch/csrc/requant.cuh"],
        "replaces": "densereg_tpu/models/layers.py:237",
        "launches": variants_launches["int8_dwconv_requant"],
        "serving_launches": launches["int8_dwconv_requant"],
        "train_launches": train_launches["int8_dwconv_requant"],
        "eval_launches": eval_launches["int8_dwconv_requant"],
        "eval_launches_by_path": None,
        "variants_launches": variants_launches["int8_dwconv_requant"],
        "tooling_launches": tooling_launches["int8_dwconv_requant"],
        "daemon_launches": daemon_launches["int8_dwconv_requant"],
        "export_launches": export_launches["int8_dwconv_requant"],
        "multigpu_launches": multigpu_launches["int8_dwconv_requant"],
        "calls_per_forward": dw_total["calls_per_forward"],
        "max_abs_err": max(t["max_abs_err"] for t in dw_totals.values()),
        "ms": dw_total["ms"], "device_ms": dw_total["device_ms"],
        "host_us": dw_total["host_us_mean"], "plain_ms": dw_total["plain_ms"],
        "bound_ms": dw_total["bound_ms"], "bound_by": dw_total["bound_by"],
        "library_ms": dw_total["library_ms"],
        # the dynamic int8 lite net's forward (bfloat16 f out of each call)
        "dynamic": {k: dw_totals["dynamic"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
            "max_abs_err")}}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
