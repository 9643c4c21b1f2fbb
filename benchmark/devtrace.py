"""Reading a ``torch.profiler`` Chrome trace: device busy time, kernel
time by name, the kernels launched inside a host range (matched through
the trace's correlation ids), and the breakdown of device time and idle
gaps. The sums by name are ``densereg_torch/tools/trace_summary.py``'s
arithmetic (complete events of a category, summed by name).

Times are seconds. The traced window is the host range named
``bench.window`` where the benchmark opened one, else the span of every
event in the trace.
"""

from __future__ import annotations

import bisect
import collections
import json
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)")


def kernel_symbols(source: str) -> List[str]:
    """The ``__global__`` functions of a CUDA source file."""
    with open(source) as f:
        return _GLOBAL.findall(f.read())


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """One trace, its events split by category, clipped to the window."""

    def __init__(self, path: str):
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X"]
        self.by_cat: Dict[str, list] = collections.defaultdict(list)
        for e in events:
            self.by_cat[e.get("cat", "")].append(e)
        wins = [e for e in self.by_cat["user_annotation"]
                if e["name"] == WINDOW]
        if wins:
            self.t0 = wins[0]["ts"]
            self.t1 = wins[0]["ts"] + wins[0]["dur"]
        else:
            self.t0 = min(e["ts"] for e in events)
            self.t1 = max(e["ts"] + e.get("dur", 0) for e in events)
        self.device = [e for c in DEVICE_CATS for e in self.by_cat[c]
                       if self.t0 <= e["ts"] < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        return _union([(e["ts"], min(e["ts"] + e.get("dur", 0), self.t1))
                       for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def events(self, cat: str, pattern: Optional[str] = None) -> list:
        """Device events of ``cat`` in the window, by name pattern."""
        rx = re.compile(pattern) if pattern else None
        return [e for e in self.device if e.get("cat") == cat
                and (rx is None or rx.search(e["name"]))]

    def seconds(self, cat: str, pattern: Optional[str] = None) -> float:
        return sum(e.get("dur", 0) for e in self.events(cat, pattern)) / 1e6

    def ranges(self, name: str) -> List[Tuple[float, float]]:
        """The host ranges named ``name`` inside the window."""
        return [(e["ts"], e["ts"] + e["dur"])
                for e in self.by_cat["user_annotation"]
                if e["name"] == name and self.t0 <= e["ts"] < self.t1]

    def kernels_launched_in(self, name: str) -> list:
        """Kernels whose launch (a runtime call, joined by its correlation
        id) lies inside a host range named ``name``."""
        spans = sorted(self.ranges(name))
        starts = [a for a, _ in spans]
        inside = set()
        for e in self.by_cat["cuda_runtime"] + self.by_cat["cuda_driver"]:
            corr = e.get("args", {}).get("correlation")
            if corr is None:
                continue
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] < spans[i][1]:
                inside.add(corr)
        return [e for e in self.events("kernel")
                if e.get("args", {}).get("correlation") in inside]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the launching host threads were doing at each
        gap's middle: the innermost host event there among the threads
        that launch a tenth of the work or more (a backward pass launches
        from autograd's own thread)."""
        ops: Dict[str, float] = collections.Counter()
        for e in self.device:
            ops[e["name"]] += e.get("dur", 0) / 1e6
        launches = collections.Counter(e.get("tid") for e in
                                       self.by_cat["cuda_runtime"])
        total = sum(launches.values())
        tids = {t for t, n in launches.items() if n >= 0.1 * total}
        host = (self.by_cat["cpu_op"] + self.by_cat["cuda_runtime"]
                + self.by_cat["user_annotation"]
                + self.by_cat["python_function"])
        threads = []
        for tid in tids:
            events = sorted((e for e in host if e.get("tid") == tid
                             and e["name"] != WINDOW), key=lambda e: e["ts"])
            threads.append((events, [e["ts"] for e in events]))
        gaps: Dict[str, float] = collections.Counter()
        edge = self.t0
        for a, b in self.busy_intervals() + [(self.t1, self.t1)]:
            if a > edge:
                mid = (edge + a) / 2
                found = [e for events, starts in threads
                         for e in [_innermost(events, starts, mid)] if e]
                label = (min(found, key=lambda e: e.get("dur", 0))["name"]
                         if found else "no host event")
                gaps[label] += (a - edge) / 1e6
            edge = max(edge, b)
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def _innermost(host: list, starts: List[float], t: float,
               scan: int = 4000):
    """The latest-starting host event that covers ``t`` (None if none):
    on one thread, where events nest, the innermost one."""
    i = bisect.bisect_right(starts, t) - 1
    for e in host[max(i - scan, -1) + 1:i + 1][::-1]:
        if t < e["ts"] + e.get("dur", 0):
            return e
    return None
