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
   its time, the plain version's, a library yardstick's and its bound.
4. ``model``: DenseRegNet s2/f128/J16 at 128x128 input (seeded random
   weights, ``init_variables``) on the card against the CPU, float32 with
   TF32 off.
5. ``serving``: the main path. ``Predictor`` serves uint16 240x320 frames
   with boxes, 1,024 per request, in float32 and bfloat16, then one lone
   frame; the kernels' launch counts are zeroed just before and read just
   after. Then its decode is held against the plain decode on the same
   heads, and the whole path against a CPU predictor.

Then a ``kernels`` line, the card's ``nvidia-smi`` name and power limit, and
as the last line ``{"ok": true, "device": {...}}``. Without a CUDA device,
or when any phase fails, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from densereg_torch import CameraConfig, NetConfig, Predictor
from densereg_torch import decode
from densereg_torch.geometry import unnorm_xyz_pose
from densereg_torch.models import from_flax, init_variables
from densereg_torch.models.bridge import seeded_depth
from densereg_torch.ops import _build
from densereg_torch.ops import fused_decode as fd
from densereg_torch.preprocess import center_of_mass, crop_from_bbx, norm_dm

SEED = 0
ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160.0, cy=120.0, w=320.0,
                    h=240.0)
# H100 SXM data sheet: HBM rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

K1_TOL = 6e-6        # normalized units (PARITY.md, fused-decode row)
HEAD_TOL = 1e-4      # per head element (PARITY.md, network row)
XYZ_TOL_MM = 0.02    # decode's 2e-4 normalized bound (PARITY.md) in mm
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


def as_served(scene, device):
    """Tensors laid out as the serving path hands them to the decode: the
    heads are NHWC views of NCHW tensors, the head-grid depth a ``[::4,
    ::4]`` view of the full-size normalized depth."""
    hms, hm3s, ums, tiny, cfgs, coms = (torch.from_numpy(a).to(device)
                                        for a in scene)
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    b, h, w, _ = tiny.shape
    full = torch.full((b, 4 * h, 4 * w, 1), -1.0, device=device)
    full[:, ::4, ::4] = tiny
    return nchw(hms), nchw(hm3s), nchw(ums), full[:, ::4, ::4], cfgs, coms


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


def phase_kernel(device, shapes=DECODE_SHAPES, iters: int = 50):
    rng = np.random.default_rng(SEED)
    rows = []
    for b, h, w, j in shapes:
        args = as_served(decode_scene(rng, b, h, w, j), device)
        got = fd.fused_decode(*args)
        torch.cuda.synchronize()
        err = (got.cpu() - plain_on_cpu(args)).abs().max().item()
        err_card = (got - fd.fused_decode_reference(*args)).abs().max().item()
        scores = decode.refined_heatmaps(*args[:2], args[3]).reshape(
            b, h * w, j).transpose(1, 2).contiguous()
        bound_ms, bound_by = decode_bound(b, h, w, j)
        row = {"phase": "kernel", "name": "fused_decode",
               "shape": {"b": b, "h": h, "w": w, "j": j},
               "max_abs_err": err, "vs_plain_on_card": err_card,
               "ms": cuda_ms(lambda: fd.fused_decode(*args), iters),
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
        rows.append(row)
    return rows


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
                  buckets=(1, 64, 256), reps: int = 3, n_cpu: int = 8):
    rng = np.random.default_rng(SEED + 2)
    distinct, bbxs = hand_frames(rng, min(n_frames, 256))
    tile = -(-n_frames // len(distinct))
    frames = np.tile(distinct, (tile, 1, 1))[:n_frames]
    bbxs = np.tile(bbxs, (tile, 1))[:n_frames]

    preds = {}
    t0 = time.perf_counter()
    for dtype in ("float32", "bfloat16"):
        cfg = NetConfig(**{**net_cfg.__dict__, "compute_dtype": dtype})
        preds[dtype] = Predictor(variables, cfg, ICVL, max_batch=max_batch,
                                 batch_buckets=buckets, device=device)
        preds[dtype].warmup()
    warmup_s = time.perf_counter() - t0

    # the main path: counts zeroed just before, read just after
    fd.fused_decode.launches = 0
    secs, xyz = {}, {}
    for dtype, pred in preds.items():
        secs[dtype] = []
        for _ in range(reps):
            t0 = time.perf_counter()
            xyz[dtype] = pred(frames, bbxs)
            secs[dtype].append(time.perf_counter() - t0)
    lone = preds["float32"](frames[:1], bbxs[:1])
    launches = {"fused_decode": fd.fused_decode.launches}
    dispatches = 2 * reps * -(-n_frames // max_batch) + 1

    on_cuda = torch.device(device).type == "cuda"
    emit({"phase": "serving", "config": net_cfg.__dict__,
          "frames_per_request": n_frames, "frame_hw": [240, 320],
          "frame_dtype": "uint16", "max_batch": max_batch,
          "batch_buckets": list(preds["float32"].batch_buckets),
          "warmup_s": warmup_s,
          "frames_per_s": {d: n_frames / statistics.median(s)
                           for d, s in secs.items()},
          "request_s": secs, "dispatches": dispatches,
          "launches": launches})
    j3 = 3 * net_cfg.num_joint
    for dtype, out in xyz.items():
        check(out.shape == (n_frames, j3) and bool(np.isfinite(out).all()),
              f"serving {dtype}: shape {out.shape} or non-finite xyz")
    if on_cuda:
        check(launches["fused_decode"] == dispatches,
              f"fused_decode launched {launches['fused_decode']} times in "
              f"{dispatches} dispatches")
    else:
        check(launches["fused_decode"] == 0, "a kernel launched on the CPU")

    # the kernel against the plain decode on the served heads
    b = min(n_frames, max_batch)
    dev_frames = torch.from_numpy(frames[:b]).to(device)
    dev_bbxs = torch.from_numpy(bbxs[:b]).to(device)
    checks = {}
    for dtype, pred in preds.items():
        heads = pred._heads(dev_frames, dev_bbxs)
        normed = decode.decode_poses(*heads, pred.ecfg)["normed"]
        err = (normed.cpu() - plain_on_cpu(heads)).abs().max().item()
        check(err <= K1_TOL, f"serving {dtype}: kernel vs plain decode {err}")
        xyz_k = unnorm_xyz_pose(normed.reshape(b, -1), heads[5]).cpu().numpy()
        checks[dtype] = {"kernel_vs_plain_normed": err,
                         "served_vs_heads_decode_mm": float(
                             np.abs(xyz_k - xyz[dtype][:b]).max())}
    gap = np.linalg.norm((xyz["bfloat16"] - xyz["float32"]).reshape(
        n_frames, -1, 3), axis=-1)
    checks["bfloat16_vs_float32_mm"] = {"median": float(np.median(gap)),
                                        "max": float(gap.max())}
    checks["lone_vs_batched_mm"] = float(np.abs(lone[0]
                                                - xyz["float32"][0]).max())

    # the whole path against a CPU predictor on the same weights
    n = min(n_cpu, n_frames)
    cpu = Predictor(variables, net_cfg, ICVL, max_batch=n, device="cpu")
    heads_cpu = cpu._heads(torch.from_numpy(frames[:n]),
                           torch.from_numpy(bbxs[:n]))
    heads_dev = tuple(t.cpu() for t in preds["float32"]._heads(
        dev_frames[:n], dev_bbxs[:n]))
    got = preds["float32"](frames[:n], bbxs[:n]).reshape(n, -1, 3)
    want = cpu(frames[:n], bbxs[:n]).reshape(n, -1, 3)
    off = np.abs(got - want).max(axis=-1) > XYZ_TOL_MM
    flips = decode_flips(heads_cpu, heads_dev, cpu.ecfg).numpy()
    head_err = max((a - c).abs().max().item()
                   for a, c in zip(heads_dev[:3], heads_cpu[:3]))
    checks["card_vs_cpu"] = {
        "frames": n, "joints": int(off.size),
        "max_mm": float(np.abs(got - want).max()),
        "max_mm_without_flips": float(np.abs(got - want)[~flips].max(
            initial=0.0)),
        "joints_off": int(off.sum()), "joints_at_a_decode_flip": int(
            flips.sum()), "max_head_err": head_err}
    emit({"phase": "serving_checks", **checks})
    check(not (off & ~flips).any(),
          f"card vs CPU: {int((off & ~flips).sum())} joints off by more "
          f"than {XYZ_TOL_MM} mm with no decode flip between the heads")
    check(head_err <= HEAD_TOL, f"card vs CPU heads {head_err}")

    emit({"phase": "serving_stages", "batch": b,
          **{d: stage_ms(p, frames[:b], bbxs[:b]) for d, p in preds.items()}})
    return launches


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
    phase_model(variables, net_cfg, "cuda")
    launches = phase_serving(variables, "cuda", net_cfg)

    main_row = rows[0]
    emit({"kernels": [{
        "name": "fused_decode", "route": "cuda",
        "source": "densereg_torch/csrc/fused_decode.cu",
        "replaces": "densereg_tpu/ops/fused_decode.py:39",
        "launches": launches["fused_decode"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
