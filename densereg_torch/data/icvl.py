"""ICVL hand dataset (reference data/icvl.py); a copy of
``densereg_tpu/data/icvl.py``, which is numpy-only, writing the same shards.

Conventions preserved: intrinsics fx=fy=241.42 cx=160 cy=120 320x240; 16
joints; training annotations filtered to lines starting with ``2014``; labels
stored as uvd in ``labels.txt`` and converted to xyz at load; 100 train / 4
test shards; exact test count 1596; fixed 500 mm background cull.
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
from densereg_torch.data.png16 import read_depth_png

CFG = CameraConfig(fx=241.42, fy=241.42, cx=160.0, cy=120.0, w=320.0, h=240.0)
JNT_NUM = 16
MAX_DEPTH = 500.0
APPROX_PER_FILE = 220  # reference data/icvl.py:13
DEFAULT_DIR = "./exp/data/icvl/"
TRAIN_SHARDS = 100
TEST_SHARDS = 4
EXACT_TEST = 1596


def _uvd2xyz_np(uvd: np.ndarray) -> np.ndarray:
    uvd = uvd.reshape(-1, 3)
    x = (uvd[:, 0] - CFG.cx) * uvd[:, 2] / CFG.fx
    y = (uvd[:, 1] - CFG.cy) * uvd[:, 2] / CFG.fy
    return np.stack([x, y, uvd[:, 2]], -1).reshape(-1)


def load_annotations(src_dir: str, is_train: bool = True,
                     use_cache: bool = True) -> List[Annotation]:
    """Parse ``labels.txt`` (uvd) -> xyz annotations with a pickle cache
    (reference data/icvl.py:90-117)."""
    path = os.path.join(src_dir, "labels")
    if use_cache and os.path.exists(path + ".pkl"):
        with open(path + ".pkl", "rb") as f:
            return pickle.load(f)
    annotations = []
    t0 = time.time()
    with open(path + ".txt") as f:
        for line in f:
            if is_train and not line.startswith("2014"):
                continue
            buf = line.split()
            pose = _uvd2xyz_np(np.asarray([float(d) for d in buf[1:]],
                                          np.float32))
            annotations.append(Annotation(buf[0], pose.astype(np.float32)))
    if use_cache:
        with open(path + ".pkl", "wb") as f:
            pickle.dump(annotations, f, protocol=pickle.HIGHEST_PROTOCOL)
    print(f"[data.icvl] {len(annotations)} annotations, "
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


def convert(directory: str = DEFAULT_DIR, subset: str = "training",
            num_threads: int = 8) -> None:
    """Offline converter: source PNGs + labels -> npz shards (equivalent of
    ``saveTFRecord``, reference data/icvl.py:152-157)."""
    if subset == "training":
        src = os.path.join(directory, "Training")
        out_dir = os.path.join(directory, "shards_train")
        n_shards, prefix = TRAIN_SHARDS, "training"
    else:
        src = os.path.join(directory, "Testing")
        out_dir = os.path.join(directory, "shards_test")
        n_shards, prefix = TEST_SHARDS, "testing"
    ann = load_annotations(src, is_train=(subset == "training"))
    paths = [os.path.join(out_dir, f"{prefix}-{i}-of-{n_shards}.npz")
             for i in range(n_shards)]
    write_shards(_SampleSource(ann, os.path.join(src, "Depth")), paths,
                 num_threads)


def _shard_paths(directory, subset):
    """Shard lists incl. the reference's subset strides
    (reference data/icvl.py:53-74): training duplicates its last shard,
    training_small takes every 10th of the first 10, validation every 21st."""
    tr = [os.path.join(directory, "shards_train",
                       f"training-{i}-of-{TRAIN_SHARDS}.npz")
          for i in range(TRAIN_SHARDS)]
    if subset == "training":
        return tr + [tr[-1]]
    if subset == "training_small":
        return [f for i, f in enumerate(tr[:10]) if i % 10 == 0]
    if subset == "validation":
        return [f for i, f in enumerate(tr[:10]) if i % 21 == 0]
    if subset == "testing":
        te = [os.path.join(directory, "shards_test",
                           f"testing-{i}-of-{TEST_SHARDS}.npz")
              for i in range(TEST_SHARDS)]
        return te + [te[-1]]
    raise ValueError(f"unknown ICVL subset {subset!r}")


@register_dataset("icvl")
def make_spec(subset: str, directory: str = DEFAULT_DIR, **_) -> DatasetSpec:
    files = _shard_paths(directory, subset)
    approx = APPROX_PER_FILE * len(files)
    return DatasetSpec(
        name="icvl",
        subset=subset,
        cfg=CFG,
        jnt_num=JNT_NUM,
        max_depth=MAX_DEPTH,
        directory=directory,
        filenames=files,
        exact_num=EXACT_TEST if subset == "testing" else approx,
        approximate_num=approx,
        fixed_bg_threshold=MAX_DEPTH,
    )
