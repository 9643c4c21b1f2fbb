"""Procedural synthetic hand scenes (a copy of
``densereg_tpu/data/synthetic.py``: the same seed renders the same shards).

The real datasets are license-gated downloads; the framework therefore ships
a deterministic synthetic dataset with the exact same contract (full-frame
uint16 depth + xyz pose + names, ICVL-style intrinsics) for end-to-end
tests, overfit correctness gates and benchmarks.  Scenes are blobby
"hands": spheres rendered at each joint of a randomly-posed kinematic blob
cluster in front of an empty background.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from densereg_torch.config import CameraConfig
from densereg_torch.data.base import DatasetSpec, ShardWriter, register_dataset

CFG = CameraConfig(fx=241.42, fy=241.42, cx=160.0, cy=120.0, w=320.0, h=240.0)
JNT_NUM = 16
DEFAULT_DIR = os.path.join(tempfile.gettempdir(), "densereg_synth")
SAMPLES_PER_SHARD = 64


def render_sample(rng: np.random.Generator, jnt_num: int = JNT_NUM,
                  cfg: CameraConfig = CFG):
    """One (depth uint16 (h,w), pose (3j,) f32) synthetic frame."""
    h, w = int(cfg.h), int(cfg.w)
    center = np.array([
        rng.uniform(-60, 60), rng.uniform(-40, 40), rng.uniform(330, 470)])
    joints = center[None, :] + np.stack([
        rng.uniform(-55, 55, jnt_num),
        rng.uniform(-55, 55, jnt_num),
        rng.uniform(-35, 35, jnt_num)], -1)
    depth = np.full((h, w), 0.0, np.float32)  # empty background = 0 (culled)
    zbuf = np.full((h, w), np.inf, np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    for j in range(jnt_num):
        x, y, z = joints[j]
        u = x * cfg.fx / z + cfg.cx
        v = y * cfg.fy / z + cfg.cy
        r_mm = rng.uniform(12, 22)
        r_px = r_mm * cfg.fx / z
        d2 = (xx - u) ** 2 + (yy - v) ** 2
        mask = d2 < r_px ** 2
        bulge = np.sqrt(np.maximum(r_mm ** 2 - d2 * (z / cfg.fx) ** 2, 0.0))
        zj = z - bulge
        closer = mask & (zj < zbuf)
        zbuf[closer] = zj[closer]
        depth[closer] = zj[closer]
    return depth.astype(np.uint16), joints.reshape(-1).astype(np.float32)


def ensure_shards(directory: str = DEFAULT_DIR, subset: str = "training",
                  num_shards: int = 4, samples_per_shard: int = SAMPLES_PER_SHARD,
                  jnt_num: int = JNT_NUM, seed: int = 0) -> list:
    """Create shards deterministically if absent; returns their paths."""
    out = os.path.join(directory, subset)
    paths = [os.path.join(out, f"{subset}-{i}-of-{num_shards}.npz")
             for i in range(num_shards)]
    if all(os.path.exists(p) for p in paths):
        return paths
    for i, p in enumerate(paths):
        rng = np.random.default_rng(seed * 10007 + i)
        with ShardWriter(p) as wshard:
            for k in range(samples_per_shard):
                depth, pose = render_sample(rng, jnt_num)
                wshard.add(depth, pose, f"{subset}/frame_{i:03d}_{k:05d}.png")
    return paths


@register_dataset("synthetic")
def make_spec(subset: str, directory: str = DEFAULT_DIR, num_shards: int = 4,
              samples_per_shard: int = SAMPLES_PER_SHARD, seed: int = 0,
              **_) -> DatasetSpec:
    files = ensure_shards(directory, subset, num_shards, samples_per_shard,
                          seed=seed + (1 if subset == "testing" else 0))
    total = num_shards * samples_per_shard
    return DatasetSpec(
        name="synthetic",
        subset=subset,
        cfg=CFG,
        jnt_num=JNT_NUM,
        max_depth=500.0,
        directory=directory,
        filenames=files,
        exact_num=total,
        approximate_num=total,
        fixed_bg_threshold=500.0,
    )
