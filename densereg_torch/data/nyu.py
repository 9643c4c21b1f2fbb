"""NYU hand dataset (reference data/nyu.py); a copy of
``densereg_tpu/data/nyu.py``, which is numpy-only, writing the same shards.

Conventions preserved: intrinsics fx=588.235 fy=587.084 cx=320 cy=240
640x480; 14 of 36 joints kept via the index list; annotations from MATLAB
``joint_data.mat`` with the y axis flipped; test crops driven by stored
bounding boxes (``nyu_bbx.pkl``-style 5-tuples); depth packed ``G<<8|B`` in
8-bit RGB PNGs; 100-of-300 train shards (+dup last), 16 test shards; exact
test count 8252.
"""

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np

from densereg_torch.config import CameraConfig
from densereg_torch.data.base import (
    Annotation,
    DatasetSpec,
    register_dataset,
    write_shards,
)
from densereg_torch.data.png16 import read_depth_png

CFG = CameraConfig(fx=588.235, fy=587.084, cx=320.0, cy=240.0, w=640.0, h=480.0)
MAX_DEPTH = 1500.0
APPROX_PER_FILE = 730
DEFAULT_DIR = "./exp/data/nyu/"
TRAIN_SHARDS_TOTAL = 300
TRAIN_SHARDS_USED = 100
TEST_SHARDS = 16
EXACT_TEST = 8252

# 14-of-36 joint selection (reference data/nyu.py:40-46)
KEEP_JOINTS = [0, 3, 6, 9, 12, 15, 18, 21, 24, 25, 27, 30, 31, 32]
KEEP_POSE_IDX = np.asarray(
    [i for j in KEEP_JOINTS for i in (3 * j, 3 * j + 1, 3 * j + 2)])
ORIG_POSE_DIM = 108
JNT_NUM = len(KEEP_JOINTS)


def load_annotations(src_dir: str, subset: str,
                     bbx_pkl: Optional[str] = None) -> List[Annotation]:
    """Read ``joint_data.mat`` (3 cameras train / 1 test), flip y, attach the
    test bounding boxes (reference data/nyu.py:97-135).  Poses are kept
    at the original 36-joint dim; the 14-joint gather happens at read time,
    like the reference's ``parse_example``."""
    import scipy.io as sio

    mat = sio.loadmat(os.path.join(src_dir, "joint_data.mat"))
    camera_num = 1 if subset == "testing" else 3
    annotations = []
    bbxes = None
    if subset == "testing":
        path = bbx_pkl or os.path.join(src_dir, "nyu_bbx.pkl")
        with open(path, "rb") as f:
            bbxes = pickle.load(f, encoding="latin1")
    for c in range(camera_num):
        joints = mat["joint_xyz"][c]
        for idx, j in enumerate(joints):
            j = np.asarray(j, np.float32).reshape(-1, 3)
            j[:, 1] *= -1.0
            name = f"depth_{c + 1}_{idx + 1:07d}.png"
            bbx = (np.asarray(bbxes[idx], np.float32).reshape(-1)
                   if bbxes is not None else None)
            annotations.append(Annotation(name, j.reshape(-1), bbx))
    return annotations


class _SampleSource:
    def __init__(self, annotations, img_dir, with_bbx):
        self.annotations = annotations
        self.img_dir = img_dir
        self.with_bbx = with_bbx

    def __len__(self):
        return len(self.annotations)

    def __getitem__(self, i):
        a = self.annotations[i]
        depth = read_depth_png(os.path.join(self.img_dir, a.name),
                               nyu_packed=True)
        if self.with_bbx:
            return depth, a.pose, a.name, a.bbx
        return depth, a.pose, a.name


def convert(directory: str = DEFAULT_DIR, subset: str = "training",
            num_threads: int = 8, bbx_pkl: Optional[str] = None) -> None:
    if subset == "training":
        src = os.path.join(directory, "dataset/train")
        out = os.path.join(directory, "shards_train")
        n, prefix = TRAIN_SHARDS_TOTAL, "training"
    else:
        src = os.path.join(directory, "dataset/test")
        out = os.path.join(directory, "shards_test")
        n, prefix = TEST_SHARDS, "testing"
    ann = load_annotations(src, subset, bbx_pkl)
    paths = [os.path.join(out, f"{prefix}-{i}-of-{n}.npz") for i in range(n)]
    write_shards(_SampleSource(ann, src, subset == "testing"), paths,
                 num_threads)


def keep_14(pose: np.ndarray) -> np.ndarray:
    """36-joint (108-dim) -> 14-joint (42-dim) gather
    (reference data/nyu.py:187)."""
    pose = np.asarray(pose)
    if pose.shape[-1] == 3 * JNT_NUM:
        return pose
    return pose[..., KEEP_POSE_IDX]


def _shard_paths(directory, subset):
    tr = [os.path.join(directory, "shards_train",
                       f"training-{i}-of-{TRAIN_SHARDS_TOTAL}.npz")
          for i in range(TRAIN_SHARDS_USED)]
    if subset == "training":
        return tr + [tr[-1]]
    if subset == "training_small":
        return [f for i, f in enumerate(tr[:30]) if i % 10 == 0]
    if subset == "validation":
        return [f for i, f in enumerate(tr) if i % 21 == 0]
    if subset == "testing":
        te = [os.path.join(directory, "shards_test",
                           f"testing-{i}-of-{TEST_SHARDS}.npz")
              for i in range(TEST_SHARDS)]
        return te + [te[-1]]
    raise ValueError(f"unknown NYU subset {subset!r}")


@register_dataset("nyu")
def make_spec(subset: str, directory: str = DEFAULT_DIR, **_) -> DatasetSpec:
    files = _shard_paths(directory, subset)
    approx = APPROX_PER_FILE * len(files)
    return DatasetSpec(
        name="nyu",
        subset=subset,
        cfg=CFG,
        jnt_num=JNT_NUM,
        max_depth=MAX_DEPTH,
        directory=directory,
        filenames=files,
        exact_num=EXACT_TEST if subset == "testing" else approx,
        approximate_num=approx,
        uses_bbx=(subset == "testing"),
        pose_select=KEEP_POSE_IDX,
    )
