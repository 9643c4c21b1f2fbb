"""Step timing.

:class:`StepTimer` is the JAX package's wall-clock step timer
(``densereg_tpu/utils/profiling.py``); on a CUDA device it synchronises
the device before it reads the clock, so a step's time includes its
device work. :class:`PhaseTimer` splits steps into phases by CUDA events.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Rolling wall-clock stats; use as a context manager around each
    step. ``last`` is the last step's seconds, ``mean`` the mean after
    ``warmup`` steps."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self.count = 0
        self.total = 0.0
        self.last = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.last = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += self.last

    @property
    def mean(self) -> float:
        n = self.count - self.warmup
        return self.total / n if n > 0 else float("nan")


class PhaseTimer:
    """Device milliseconds of the phases of the current CUDA stream's work.

    ``start()`` records an event; each ``mark(name)`` records another and
    charges the time since the previous event to ``name``; ``split()``
    synchronises and returns the milliseconds charged to each name since
    ``start()``. (On a stream the host cannot keep fed, an interval also
    counts the device's wait for the host.)"""

    def __init__(self):
        self._events: List[Tuple[str, torch.cuda.Event]] = []

    def _record(self, name: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self._events.append((name, event))

    def start(self) -> None:
        self._events = []
        self._record("")

    def mark(self, name: str) -> None:
        self._record(name)

    def split(self) -> Dict[str, float]:
        torch.cuda.synchronize()
        out: Dict[str, float] = defaultdict(float)
        for (_, a), (name, b) in zip(self._events, self._events[1:]):
            out[name] += a.elapsed_time(b)
        return dict(out)
