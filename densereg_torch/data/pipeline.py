"""Input pipelines: npz shards on the host, crop on the device.

Mirrors ``densereg_tpu/data/pipeline.py``. Producer threads assemble
shuffled batches of raw full frames in numpy, the depth kept uint16 (2
bytes a pixel over the bus); the consumer pins them, copies them to
``device`` and runs the crop and center of mass there
(``preprocess.preprocess_batch_from_pose``), in the layout of the training
step's ``(sub_batch, batch, ...)`` axes.

With ``host_preprocess`` the crop runs on the host instead, in the
producer threads, on CPU tensors, and the cropped float32 batch crosses
the bus; with ``wire_dtype="uint16"`` it crosses as the per-batch
fixed-point uint16 of ``densereg_torch.wire`` and is decoded on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from densereg_torch.data.base import DatasetSpec
from densereg_torch.preprocess import (
    preprocess_batch_from_bbx,
    preprocess_batch_from_pose,
)
from densereg_torch.utils.device import to_device
from densereg_torch.utils.profiling import span
from densereg_torch.wire import check_wire, decode_dm_u16, encode_dm_u16


def partition_for_host(items, host_id: int, num_hosts: int):
    """Disjoint round-robin split of shards across processes (a copy of
    ``densereg_tpu/data/pipeline.py::partition_for_host``); when there are
    fewer shards than processes every process keeps them all (they then
    diverge by their process-seeded shuffle order instead)."""
    if num_hosts <= 1 or len(items) < num_hosts:
        return list(items)
    return list(items[host_id::num_hosts])


def _load_frames(reader, idxs, spec: DatasetSpec):
    """Depth ``(n, H, W, 1)`` in the shard's dtype, poses ``(n, 3j)``
    float32, names and (where the shard has them) boxes ``(n, 5)``."""
    depth = reader["depth"][idxs][..., None]
    pose = reader["pose"][idxs].astype(np.float32)
    if spec.pose_select is not None and pose.shape[-1] != spec.pose_dim:
        pose = pose[:, spec.pose_select]
    names = [str(n) for n in reader["name"][idxs]]
    bbx = reader["bbx"][idxs].astype(np.float32) if reader.has_bbx else None
    return depth, pose, names, bbx


def _host_crop(out, wire_dtype: str):
    """A host-preprocessed batch ``(dm, pose, cfgs, coms)`` as it crosses
    the bus: as it is (``float32``), or with ``dm`` encoded as the uint16
    wire's ``(q, scale)``."""
    dm, rest = out[0], tuple(out[1:])
    if wire_dtype == "uint16":
        return encode_dm_u16(dm.numpy()) + rest
    return (dm,) + rest


def _from_wire(item, wire_dtype: str, device: torch.device):
    """The inverse of :func:`_host_crop` on ``device``: ``(dm, pose, cfgs,
    coms)``, the uint16 wire decoded there."""
    if wire_dtype == "uint16":
        q, scale = item[:2]
        dm = decode_dm_u16(to_device(q, device), to_device(scale, device))
        rest = item[2:]
    else:
        dm, rest = to_device(item[0], device), item[1:]
    return (dm,) + tuple(to_device(x, device) for x in rest)


class InputPipeline:
    """Shuffled, endless training pipeline.

    Yields dicts ``{dm, pose, cfg, com}`` of tensors on ``device`` with
    leading axes ``(sub_batch, batch_size, ...)``: ``dm`` the cropped depth
    in mm, float32. Producer ``i`` draws its shard and frame order from
    ``np.random.default_rng(seed + 7919 i)``, as the JAX package's does;
    with one producer the stream is a function of ``seed`` alone, and
    ``skip`` drops its first ``skip`` batches without loading them (where a
    resumed run picks the stream up). ``host_preprocess`` crops in the
    producers, on the CPU, and ``wire_dtype`` is how the crop crosses the
    bus (``float32``, or ``uint16`` with ``host_preprocess``).

    With a ``mesh`` (``parallel.make_mesh``) of n processes, rank r reads
    its :func:`partition_for_host` share of the shards and yields its
    ``batch_size / n`` frames of each micro-batch (``local_batch``), on the
    mesh's first device, its producer ``i`` seeded with ``seed + 7919 i +
    104729 r``, as the JAX pipeline does under ``jax.distributed``.
    """

    def __init__(self, spec: DatasetSpec, batch_size: int, sub_batch: int = 1,
                 input_hw=(128, 128), seed: int = 0, prefetch: int = 4,
                 num_workers: int = 1, skip: int = 0,
                 host_preprocess: bool = False, wire_dtype: str = "float32",
                 mesh=None, device="cuda"):
        check_wire(host_preprocess, wire_dtype)
        self._num_hosts = mesh.world_size if mesh is not None else 1
        self._host_id = mesh.rank if mesh is not None else 0
        if batch_size % self._num_hosts:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{self._num_hosts} processes")
        if mesh is not None:
            device = mesh.devices[0]
        self.spec = spec
        self.batch_size = batch_size
        self.local_batch = batch_size // self._num_hosts
        self.sub_batch = sub_batch
        self.input_hw = tuple(input_hw)
        self.host_preprocess = host_preprocess
        self.wire_dtype = wire_dtype
        self.device = torch.device(device)
        self._cfg = spec.cfg.as_array(device=self.device)
        self._host_cfg = spec.cfg.as_array()
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._producer,
                             args=(np.random.default_rng(
                                 seed + 7919 * i + 104729 * self._host_id),
                                   skip),
                             daemon=True)
            for i in range(max(num_workers, 1))]
        for t in self._threads:
            t.start()

    def _put(self, item) -> bool:
        """Deliver ``item``, waiting while the queue is full; False once the
        pipeline is closed."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=1.0)
                return True
            except queue.Full:
                continue
        return False

    def _producer(self, rng: np.random.Generator, skip: int):
        try:
            readers = partition_for_host(
                [r for r in self.spec.readers() if len(r) > 0],
                self._host_id, self._num_hosts)
            need = self.local_batch * self.sub_batch
            pool: List[Tuple[int, np.ndarray]] = []   # (reader, frames)
            total = 0
            while not self._stop.is_set():
                for ri in rng.permutation(len(readers)):
                    pool.append((ri, rng.permutation(len(readers[ri]))))
                    total += len(pool[-1][1])
                    while total >= need:
                        take, left = [], need
                        while left:
                            ri_, idxs = pool[0]
                            take.append((ri_, idxs[:left]))
                            if len(idxs) > left:
                                pool[0] = (ri_, idxs[left:])
                            else:
                                pool.pop(0)
                            left -= len(take[-1][1])
                        total -= need
                        if skip:
                            skip -= 1
                            continue
                        loaded = [_load_frames(readers[r], ix, self.spec)
                                  for r, ix in take]
                        item = (np.concatenate([x[0] for x in loaded]),
                                np.concatenate([x[1] for x in loaded]))
                        if self.host_preprocess:
                            item = _host_crop(self._crop(
                                *(torch.from_numpy(x) for x in item),
                                self._host_cfg), self.wire_dtype)
                        if not self._put(item):
                            return
                    if self._stop.is_set():
                        return
        except Exception as exc:   # handed to the consumer, which raises it
            self._put(exc)

    def __iter__(self) -> Iterator[dict]:
        h, w = self.input_hw
        sub, b = self.sub_batch, self.local_batch
        while True:
            with span("densereg.pipeline.wait"):
                item = self._q.get()
            if isinstance(item, Exception):
                raise RuntimeError("input pipeline producer failed") from item
            with span("densereg.pipeline.feed"):
                if self.host_preprocess:
                    dm, pose, cfgs, coms = _from_wire(item, self.wire_dtype,
                                                      self.device)
                else:
                    dm, pose, cfgs, coms = self._crop(
                        *(to_device(x, self.device) for x in item),
                        self._cfg)
            yield {"dm": dm.reshape(sub, b, h, w, 1),
                   "pose": pose.reshape(sub, b, -1),
                   "cfg": cfgs.reshape(sub, b, 6),
                   "com": coms.reshape(sub, b, 3)}

    def _crop(self, dms, poses, cfg):
        h, w = self.input_hw
        return preprocess_batch_from_pose(dms, poses, cfg, h, w,
                                          self.spec.fixed_bg_threshold)

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=10.0)


class TestPipeline:
    """Sequential single-pass pipeline yielding ``{dm, pose, cfg, com,
    name}`` batches on ``device``: cropped around the pose, or from the
    stored boxes where the spec uses them. The last batch is padded by
    repeating its last frame, so every batch has ``batch_size`` frames.
    ``host_preprocess`` and ``wire_dtype`` as in :class:`InputPipeline`:
    the crop is made on the CPU and decoded on ``device``.

    ``shard_slice`` restricts the pass to a contiguous range of
    :meth:`unique_readers`, the unit that the multi-process evaluation
    (``eval.loop.evaluate_multihost``) splits: contiguous ranges keep the
    dataset's order when the parts are concatenated. A ``mesh`` of more
    than one process is refused, as in the JAX package: one global batch
    is not split across processes at test time; each process evaluates its
    own shards instead."""

    def __init__(self, spec: DatasetSpec, batch_size: int,
                 input_hw=(128, 128), host_preprocess: bool = False,
                 wire_dtype: str = "float32",
                 shard_slice: Optional[slice] = None, mesh=None,
                 device="cuda"):
        check_wire(host_preprocess, wire_dtype)
        if mesh is not None:
            if mesh.world_size > 1:
                raise NotImplementedError(
                    "TestPipeline cannot split one global batch across "
                    "processes; use eval.loop.evaluate_multihost "
                    "(shard-partitioned local inference, rank-0 merge)")
            device = mesh.devices[0]
        self.shard_slice = shard_slice
        self.spec = spec
        self.batch_size = batch_size
        self.input_hw = tuple(input_hw)
        self.host_preprocess = host_preprocess
        self.wire_dtype = wire_dtype
        self.device = torch.device(device)
        self._cfg = spec.cfg.as_array(device=self.device)
        self._host_cfg = spec.cfg.as_array()

    def unique_readers(self):
        """The non-empty shards in dataset order, each once."""
        out, seen = [], set()
        for reader in self.spec.readers():
            if reader.path in seen or len(reader) == 0:
                continue
            seen.add(reader.path)
            out.append(reader)
        return out

    def __iter__(self) -> Iterator[dict]:
        bs = self.batch_size
        buf_d, buf_p, buf_n, buf_b = [], [], [], []
        readers = self.unique_readers()
        if self.shard_slice is not None:
            readers = readers[self.shard_slice]
        for reader in readers:
            d, p, names, bbx = _load_frames(reader, np.arange(len(reader)),
                                            self.spec)
            for i in range(len(names)):
                buf_d.append(d[i])
                buf_p.append(p[i])
                buf_n.append(names[i])
                if bbx is not None:
                    buf_b.append(bbx[i])
                if len(buf_d) == bs:
                    yield self._emit(buf_d, buf_p, buf_n, buf_b)
                    buf_d, buf_p, buf_n, buf_b = [], [], [], []
        if buf_d:
            pad = bs - len(buf_d)
            for buf in (buf_d, buf_p, buf_n) + ((buf_b,) if buf_b else ()):
                buf.extend([buf[-1]] * pad)
            yield self._emit(buf_d, buf_p, buf_n, buf_b)

    def _emit(self, buf_d, buf_p, buf_n, buf_b) -> dict:
        h, w = self.input_hw
        crop_on = torch.device("cpu") if self.host_preprocess else self.device
        dms = to_device(np.stack(buf_d), crop_on)
        poses = to_device(np.stack(buf_p), crop_on)
        cfg = self._host_cfg if self.host_preprocess else self._cfg
        if self.spec.uses_bbx and buf_b:
            out = preprocess_batch_from_bbx(
                dms, poses, to_device(np.stack(buf_b), crop_on), cfg, h, w)
        else:
            out = preprocess_batch_from_pose(dms, poses, cfg, h, w,
                                             self.spec.fixed_bg_threshold)
        if self.host_preprocess:
            out = _from_wire(_host_crop(out, self.wire_dtype),
                             self.wire_dtype, self.device)
        dm, pose, cfgs, coms = out
        return {"dm": dm, "pose": pose, "cfg": cfgs, "com": coms,
                "name": list(buf_n)}
