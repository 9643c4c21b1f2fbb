"""BigHand 2.2M dataset: offline converter + loader (a copy of
``densereg_tpu/data/bighand.py``, which is numpy-only).

The reference CLI dispatches ``--dataset bighand`` to a ``data.bigHand``
module that is NOT shipped in its snapshot (the import at
reference model/hourglass_um_crop_tiny.py:886-889 would fail), so this
is a from-scratch implementation of the published dataset layout rather than
a port: Intel RealSense SR300 depth frames (640x480 16-bit PNG, mm) with
camera-space xyz annotations for 21 joints (wrist, 5 MCPs, then 5 fingers x
3: the ordering drawn by the reference's bighand skeleton,
reference data/visualization.py:63-70), distributed as
``Training_Annotation.txt`` / ``Test_Annotation.txt`` files of
``<frame path> <63 floats>`` lines.

The dataset itself is license-gated (HANDS 2017 challenge); with the source
tree present, ``convert`` shards it into the framework's npz format and
``make_spec`` serves it like every other dataset.
"""

from __future__ import annotations

import glob
import json
import os
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
from densereg_torch.data.png16 import read_depth_png

# Intel RealSense SR300 intrinsics published with the dataset.
CFG = CameraConfig(fx=475.065948, fy=475.065857, cx=315.944855,
                   cy=245.287079, w=640.0, h=480.0)
JNT_NUM = 21
MAX_DEPTH = 1000.0
DEFAULT_DIR = "./exp/data/bighand/"
TRAIN_SHARDS = 256
TEST_SHARDS = 16

_ANNOT_FILES = {
    "training": ("Training_Annotation.txt",),
    "testing": ("Test_Annotation.txt", "Testing_Annotation.txt"),
}


def _annotation_path(directory: str, subset: str) -> str:
    key = "training" if subset.startswith("training") else "testing"
    for name in _ANNOT_FILES[key]:
        path = os.path.join(directory, name)
        if os.path.exists(path):
            return path
    raise FileNotFoundError(
        f"no BigHand annotation file for {subset!r} under {directory} "
        f"(expected one of {_ANNOT_FILES[key]})")


def load_annotations(directory: str, subset: str) -> List[Annotation]:
    """Parse ``<frame path> <x1 y1 z1 ... x21 y21 z21>`` lines (camera-space
    xyz, mm)."""
    path = _annotation_path(directory, subset)
    annotations = []
    t0 = time.time()
    with open(path) as f:
        for line in f:
            buf = line.split()
            if len(buf) != 1 + 3 * JNT_NUM:
                continue  # header/blank lines
            pose = np.asarray([float(d) for d in buf[1:]], np.float32)
            annotations.append(Annotation(buf[0].replace("\\", "/"), pose))
    print(f"[data.bighand] {len(annotations)} annotations from {path}, "
          f"{time.time() - t0:.2f}s")
    return annotations


class _SampleSource:
    def __init__(self, annotations, img_dir):
        self.annotations = annotations
        self.img_dir = img_dir

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, i):
        a = self.annotations[i]
        depth = read_depth_png(os.path.join(self.img_dir, a.name))
        return depth, a.pose, a.name


def _shard_glob(directory: str, subset: str) -> List[str]:
    key = "training" if subset.startswith("training") else "testing"
    return sorted(glob.glob(os.path.join(
        directory, "shards", f"{key}-*-of-*.npz")))


def convert(directory: str = DEFAULT_DIR, subset: str = "training",
            num_threads: int = 8) -> None:
    """Source tree -> npz shards + a ``meta_<subset>.json`` sample count."""
    key = "training" if subset.startswith("training") else "testing"
    ann = load_annotations(directory, key)
    n_shards = TRAIN_SHARDS if key == "training" else TEST_SHARDS
    # don't spread a small (e.g. subsampled) copy over mostly-empty shards
    n_shards = max(1, min(n_shards, (len(ann) + 999) // 1000))
    out = [os.path.join(directory, "shards",
                        f"{key}-{i}-of-{n_shards}.npz")
           for i in range(n_shards)]
    img_dir = os.path.join(directory, "images")
    if not os.path.isdir(img_dir):
        img_dir = directory  # annotations may carry full relative paths
    write_shards(_SampleSource(ann, img_dir), out, num_threads)
    with open(os.path.join(directory, f"meta_{key}.json"), "w") as f:
        json.dump({"count": len(ann), "shards": n_shards}, f)


def _exact_count(directory: str, subset: str, fallback: int) -> int:
    key = "training" if subset.startswith("training") else "testing"
    meta = os.path.join(directory, f"meta_{key}.json")
    if os.path.exists(meta):
        with open(meta) as f:
            return int(json.load(f)["count"])
    return fallback


@register_dataset("bighand")
def make_spec(subset: str, directory: str = DEFAULT_DIR, **_) -> DatasetSpec:
    files = _shard_glob(directory, subset)
    if not files:
        raise FileNotFoundError(
            "no BigHand shards under %s; run `densereg_torch.data.bighand."
            "convert` on the (license-gated) source tree first "
            "(the reference never shipped its bighand loader at all, "
            "reference model/hourglass_um_crop_tiny.py:886)"
            % os.path.join(directory, "shards"))
    if subset == "training_small":
        files = files[::16] or files[:1]
    approx = _exact_count(directory, subset, 1000 * len(files))
    if subset == "training_small":
        approx = max(1, approx // 16)
    return DatasetSpec(
        name="bighand", subset=subset, cfg=CFG, jnt_num=JNT_NUM,
        max_depth=MAX_DEPTH, directory=directory, filenames=files,
        exact_num=_exact_count(directory, subset, 1000 * len(files))
        if subset == "testing" else approx,
        approximate_num=approx)
