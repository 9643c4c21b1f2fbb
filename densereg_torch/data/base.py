"""Dataset registry + shard storage (a copy of ``densereg_tpu/data/base.py``,
which is numpy-only; the shard format is the same, so one conversion feeds
both packages).

* ``ShardWriter``/``ShardReader``: compressed ``.npz`` shards holding
  ``depth (N, h, w) uint16``, ``pose (N, 3j) float32``, ``name (N) str`` and
  optionally ``bbx (N, 5) float32`` — trivially memory-mappable and
  numpy-native, no protobuf parse on the hot path;
* ``DatasetSpec``: the per-dataset contract the pipeline and trainers consume
  (``cfg``, ``jnt_num``, ``pose_dim``, ``exact_num``, ``filenames`` per
  subset...), mirroring the reference's ``BaseDataset`` surface
  (reference data/dataset_base.py:129-237 and subclasses).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from densereg_torch.config import CameraConfig


@dataclasses.dataclass
class Annotation:
    """(reference data/dataset_base.py:17); bbx only for NYU test."""
    name: str
    pose: np.ndarray
    bbx: Optional[np.ndarray] = None


class ShardWriter:
    def __init__(self, path: str):
        self.path = path
        self._depth: List[np.ndarray] = []
        self._pose: List[np.ndarray] = []
        self._name: List[str] = []
        self._bbx: List[np.ndarray] = []

    def add(self, depth: np.ndarray, pose: np.ndarray, name: str,
            bbx: Optional[np.ndarray] = None) -> None:
        self._depth.append(np.asarray(depth, np.uint16))
        self._pose.append(np.asarray(pose, np.float32).reshape(-1))
        self._name.append(name)
        if bbx is not None:
            self._bbx.append(np.asarray(bbx, np.float32).reshape(-1))

    def close(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        arrays = dict(
            depth=np.stack(self._depth) if self._depth else
            np.zeros((0, 1, 1), np.uint16),
            pose=np.stack(self._pose) if self._pose else
            np.zeros((0, 0), np.float32),
            name=np.asarray(self._name),
        )
        if self._bbx:
            arrays["bbx"] = np.stack(self._bbx)
        np.savez_compressed(self.path, **arrays)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardReader:
    """Lazily-opened shard; arrays decompressed once and cached."""

    def __init__(self, path: str):
        self.path = path if path.endswith(".npz") else path + ".npz"
        self._data = None
        self._lock = threading.Lock()

    def _load(self):
        if self._data is None:
            with self._lock:
                if self._data is None:
                    with np.load(self.path, allow_pickle=False) as z:
                        self._data = {k: z[k] for k in z.files}
        return self._data

    def __len__(self):
        return len(self._load()["name"])

    def __getitem__(self, key):
        return self._load()[key]

    @property
    def has_bbx(self):
        return "bbx" in self._load()

    def drop_cache(self):
        self._data = None


def write_shards(samples, shard_paths: Sequence[str], num_threads: int = 1,
                 log_fn=print) -> None:
    """Write an indexable sample source into shards, multi-threaded over
    shards (equivalent of ``write_TFRecord_multi_thread``,
    reference data/dataset_base.py:92-127).

    ``samples``: object with ``__len__`` and ``__getitem__`` returning
    (depth, pose, name[, bbx]).
    """
    n = len(samples)
    k = len(shard_paths)
    spacing = np.linspace(0, n, k + 1).astype(int)

    def run(shard_indices):
        for si in shard_indices:
            with ShardWriter(shard_paths[si]) as w:
                for i in range(spacing[si], spacing[si + 1]):
                    item = samples[i]
                    w.add(*item)
            log_fn(f"[data] wrote {shard_paths[si]} "
                   f"({spacing[si + 1] - spacing[si]} samples)")

    if num_threads <= 1:
        run(range(k))
        return
    chunks = np.array_split(np.arange(k), num_threads)
    threads = [threading.Thread(target=run, args=(c,)) for c in chunks if len(c)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


@dataclasses.dataclass
class DatasetSpec:
    """The model-facing dataset contract (cf. the reference's per-dataset
    class attributes, e.g. reference data/icvl.py:12-21)."""

    name: str
    subset: str
    cfg: CameraConfig
    jnt_num: int
    max_depth: float
    directory: str
    filenames: List[str]
    exact_num: int
    approximate_num: int
    # ICVL uses a fixed background-cull threshold; others min-joint+250
    # (reference data/preprocess.py:64-67)
    fixed_bg_threshold: Optional[float] = None
    uses_bbx: bool = False
    # optional index gather applied to stored poses at read time (NYU keeps
    # 14 of 36 joints, reference data/nyu.py:40-46,187)
    pose_select: Optional[np.ndarray] = None

    @property
    def pose_dim(self) -> int:
        return 3 * self.jnt_num

    def readers(self) -> List[ShardReader]:
        return [ShardReader(f) for f in self.filenames]


_REGISTRY: Dict[str, Callable] = {}


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_dataset(name: str, subset: str, **kwargs) -> DatasetSpec:
    """Registry dispatch, the equivalent of the reference CLI's dataset
    if/elif ladder (reference model/hourglass_um_crop_tiny.py:885-905).
    ``name`` in {icvl, nyu, msra, bighand, synthetic}."""
    import densereg_torch.data.icvl  # noqa: F401  (register on import)
    import densereg_torch.data.nyu  # noqa: F401
    import densereg_torch.data.msra  # noqa: F401
    import densereg_torch.data.bighand  # noqa: F401
    import densereg_torch.data.synthetic  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(f"unknown dataset {name!r}; densereg_torch has "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](subset=subset, **kwargs)
