"""Device mesh and batch sharding, the port of ``densereg_tpu/parallel/mesh.py``
in PyTorch's idiom.

In the JAX package a mesh is a grid of devices that XLA partitions one
program over. In the port a :class:`Mesh` is a process group plus this
process's local devices: every process runs the same program on its own
slice of the global batch, and the collectives (the gradient all-reduce,
the synchronized renorm moments, the gather of served joints) go through
``torch.distributed`` on the group. Sharding a batch keeps this rank's
slice of it; a replicated value is the whole of it on every rank. The names
follow the JAX module so that a reader finds the counterpart.

The workload is pure data parallelism over a ~2M-parameter convnet, so the
mesh has one axis, ``data``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from densereg_torch.utils.device import visible_devices


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: this process's devices; ``group``: the process group
    that joins the processes of the mesh, None for a mesh of one process
    with no collective (a one-rank group still runs its collectives).
    Under a group each process holds one device, its own card: a
    collective takes one tensor a rank."""

    devices: Tuple[torch.device, ...]
    group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if not self.devices:
            raise RuntimeError("make_mesh: no devices (no visible card; pass "
                               "devices=['cpu'] to run on the CPU)")
        if self.group is not None and len(self.devices) != 1:
            raise ValueError(f"make_mesh: one device a process under a "
                             f"process group (start one process per card), "
                             f"got {len(self.devices)} local devices")

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def world_size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """The number of devices over all the processes of the mesh."""
        return self.world_size * len(self.devices)


def make_mesh(devices=None, group=None) -> Mesh:
    """The mesh of ``group`` (default: the default process group where one
    is initialized, else none). Under a group ``devices`` defaults to this
    process's card, the one :func:`initialize_distributed` made current;
    without one, to every visible card, over which a ``Predictor`` splits
    its dispatches."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if devices is None:
        if group is None:
            devices = visible_devices("cuda")
        elif torch.cuda.is_available():
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = []
    return Mesh(tuple(torch.device(d) for d in devices), group)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a value lies on a mesh: split along ``batch_dim`` over its
    processes, or replicated (``batch_dim`` None)."""

    mesh: Mesh
    batch_dim: Optional[int] = None

    def local(self, x):
        """This rank's part of the global value ``x``: its contiguous slice
        of ``batch_dim`` (rank r of n keeps rows ``[r * m / n, (r + 1) *
        m / n)``), or all of ``x`` when replicated."""
        if self.batch_dim is None:
            return x
        m, n = x.shape[self.batch_dim], self.mesh.world_size
        if m % n:
            raise ValueError(f"batch of {m} does not split over {n} "
                             f"processes")
        return x.narrow(self.batch_dim, self.mesh.rank * (m // n), m // n)


def batch_sharding(mesh: Mesh, batch_dim: int = 0) -> Sharding:
    """A batch split along ``batch_dim`` over the mesh's processes."""
    return Sharding(mesh, batch_dim)


def replicated_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(batch, mesh: Mesh, batch_dim: int = 0):
    """This rank's slice of a (possibly nested) global batch of arrays or
    tensors, as tensors on the mesh's first local device."""
    sharding = batch_sharding(mesh, batch_dim)

    def place(x):
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        t = torch.as_tensor(np.ascontiguousarray(x)
                            if isinstance(x, np.ndarray) else x)
        return sharding.local(t).to(mesh.devices[0])

    return place(batch)
