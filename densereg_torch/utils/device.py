"""Device and environment shim, the port of ``densereg_tpu/utils/device.py``.

PyTorch finds the cards through CUDA; this module only provides (a)
environment-driven device restriction, (b) a topology report, (c) the
device an entry point runs on when it is given none: the first visible
card, never the CPU unless the caller asks for it, and (d) the one copy of
host data to a device that serving and the input pipelines feed through.

Environment variables honoured:
  DENSEREG_VISIBLE_DEVICES  comma list of local device indices to use
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch


def to_device(a, device: torch.device) -> torch.Tensor:
    """``a`` (an array or a CPU tensor) on ``device``: to a card through
    pinned memory, the copy enqueued without waiting for it."""
    t = torch.as_tensor(np.ascontiguousarray(a) if isinstance(a, np.ndarray)
                        else a)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def visible_devices(platform: str = "cuda") -> List[torch.device]:
    """The local devices of ``platform`` (``"cuda"`` or ``"cpu"``), filtered
    by ``DENSEREG_VISIBLE_DEVICES``. The CPU is one device, index 0."""
    if platform == "cuda":
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    elif platform == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")
    spec = os.environ.get("DENSEREG_VISIBLE_DEVICES")
    if not spec:
        return devices
    idx = {int(s) for s in spec.split(",") if s.strip() != ""}
    return [d for d in devices if (d.index or 0) in idx]


def topology_report() -> str:
    """A human-readable summary: this process's rank and the world size of
    the process group (1/1 without one), then each visible card by name."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
        backend = dist.get_backend()
    else:
        rank, world, backend = 0, 1, "none"
    lines = [f"process {rank}/{world}, process group backend: {backend}, "
             f"cuda available: {torch.cuda.is_available()}"]
    for d in visible_devices("cuda"):
        lines.append(f"  [{d.index}] cuda:{torch.cuda.get_device_name(d)}")
    return "\n".join(lines)


def default_device(platform: str = "cuda") -> torch.device:
    """The first visible device of ``platform``: a card unless the caller
    asks for ``"cpu"``. Raises where there is none; it never falls back to
    the CPU."""
    devs = visible_devices(platform)
    if not devs:
        raise RuntimeError(f"no visible {platform} device (none present, or "
                           f"DENSEREG_VISIBLE_DEVICES filtered all out)")
    return devs[0]
