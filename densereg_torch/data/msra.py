"""MSRA15 hand dataset (reference data/msra.py); a copy of
``densereg_tpu/data/msra.py``, which is numpy-only, writing the same shards.

Conventions preserved: ICVL-style intrinsics; 21 joints; 17 gesture
directories; leave-one-subject-out protocol over subjects P0..P8 (training =
all other subjects' shards, testing = the held-out subject); ``joint.txt``
labels with y and z negated; the proprietary ``.bin`` cropped-depth format
converted to full-frame 16-bit PNGs (empty frames copy the previous one);
per-subject exact test counts; shard naming ``P%d-%d-of-%d``.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import List

import numpy as np

from densereg_torch.config import CameraConfig
from densereg_torch.data.base import (
    Annotation,
    DatasetSpec,
    register_dataset,
    write_shards,
)
from densereg_torch.data.png16 import read_depth_png, read_msra_bin

CFG = CameraConfig(fx=241.42, fy=241.42, cx=160.0, cy=120.0, w=320.0, h=240.0)
JNT_NUM = 21
MAX_DEPTH = 1000.0
APPROX_PER_FILE = 85
DEFAULT_DIR = "./exp/data/msra15/"
SHARDS_PER_PID = 100
POSE_LIST = "1 2 3 4 5 6 7 8 9 I IP L MP RP T TIP Y".split()
# per-subject exact test counts (reference data/msra.py:70)
PID_NUM = [8499, 8492, 8412, 8488, 8500, 8497, 8497, 8498, 8492]
NUM_PIDS = 9


def load_annotations(src_dir: str, use_cache: bool = True) -> List[Annotation]:
    """Per-gesture ``joint.txt`` with y,z negated
    (reference data/msra.py:81-118)."""
    cache = os.path.join(src_dir, "labels.pkl")
    if use_cache and os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)
    annotations = []
    t0 = time.time()
    for pose_name in POSE_LIST:
        with open(os.path.join(src_dir, pose_name, "joint.txt")) as f:
            for frm, line in enumerate(f):
                if frm == 0:  # first line is the frame count
                    continue
                vals = np.asarray([float(d) for d in line.split()], np.float32)
                vals = vals.reshape(-1, 3)
                vals[:, 1] *= -1.0
                vals[:, 2] *= -1.0
                name = os.path.join(pose_name, "%06i_depth" % (frm - 1))
                annotations.append(Annotation(name, vals.reshape(-1)))
    if use_cache:
        with open(cache, "wb") as f:
            pickle.dump(annotations, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"[data.msra] {len(annotations)} annotations, {time.time()-t0:.2f}s")
    return annotations


def convert_bin_to_png(src_dir: str, log_fn=print) -> None:
    """``.bin`` -> full-frame uint16 PNG, empty frames copying the previous
    one (reference data/msra.py:120-149)."""
    import cv2

    prev = None
    for idx, a in enumerate(load_annotations(src_dir)):
        full = read_msra_bin(os.path.join(src_dir, a.name + ".bin"))
        if full.sum() < 10:
            log_fn(f"[warning] {a.name} is empty")
            if prev is not None:
                full = prev
        prev = full.copy()
        cv2.imwrite(os.path.join(src_dir, a.name + ".png"),
                    full.astype(np.uint16))
        if idx % 500 == 0:
            log_fn(f"[data.msra] {idx} frames converted")


class _SampleSource:
    def __init__(self, annotations, img_dir):
        self.annotations = annotations
        self.img_dir = img_dir

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, i):
        a = self.annotations[i]
        depth = read_depth_png(os.path.join(self.img_dir, a.name + ".png"))
        return depth, a.pose, a.name


def convert(directory: str = DEFAULT_DIR, pid: int = 0,
            num_threads: int = 8, do_bin_conversion: bool = True) -> None:
    """Convert one subject; run for pid in 0..8 for the full protocol
    (reference data/msra.py:210-215)."""
    src = os.path.join(directory, f"P{pid}")
    if do_bin_conversion:
        convert_bin_to_png(src)
    ann = load_annotations(src)
    out = os.path.join(directory, "shards")
    paths = [os.path.join(out, f"P{pid}-{i}-of-{SHARDS_PER_PID}.npz")
             for i in range(SHARDS_PER_PID)]
    write_shards(_SampleSource(ann, src), paths, num_threads)


def _shard_paths(directory, subset, pid):
    """Leave-one-subject-out shard lists (reference data/msra.py:49-64).
    Note: the reference has a latent bug here — its training list re-uses
    ``self.pid`` in the filename for every other subject, so training would
    read the held-out subject's shards 8 times.  We implement the intended
    protocol (all subjects except ``pid``)."""
    out = os.path.join(directory, "shards")
    if subset == "training":
        files = []
        for p in range(NUM_PIDS):
            if p == pid:
                continue
            files += [os.path.join(out, f"P{p}-{i}-of-{SHARDS_PER_PID}.npz")
                      for i in range(SHARDS_PER_PID)]
        return files + [files[-1]]
    if subset == "testing":
        files = [os.path.join(out, f"P{pid}-{i}-of-{SHARDS_PER_PID}.npz")
                 for i in range(SHARDS_PER_PID)]
        return files + [files[-1]]
    raise ValueError(f"unknown MSRA subset {subset!r}")


@register_dataset("msra")
def make_spec(subset: str, pid: int = 0, directory: str = DEFAULT_DIR,
              **_) -> DatasetSpec:
    files = _shard_paths(directory, subset, pid)
    approx = APPROX_PER_FILE * len(files)
    return DatasetSpec(
        name=f"msra_P{pid}",
        subset=subset,
        cfg=CFG,
        jnt_num=JNT_NUM,
        max_depth=MAX_DEPTH,
        directory=directory,
        filenames=files,
        exact_num=PID_NUM[pid] if subset == "testing" else approx,
        approximate_num=approx,
    )
