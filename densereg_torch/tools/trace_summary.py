"""Summarize a ``torch.profiler`` trace without TensorBoard, the counterpart
of ``tools/trace_summary.py`` for the Chrome traces the port writes
(``*.pt.trace.json``: ``TrainConfig.profile_dir``,
``utils.profiling.trace_context``).

Sums the complete events (``ph == "X"``) of one category by name: the GPU
kernels (``cat == "kernel"``) by default, the counterpart of the JAX
tool's device-only "XLA Ops" line; ``--line`` takes another category
(``gpu_memcpy``, ``cpu_op``, ``cuda_runtime``). A kernel row of the port's
own kernels carries its id from ``PERF.md``'s table (K1, K2, K3, DW) in a
column of its own, matched by the ``__global__`` symbols of
``densereg_torch/csrc/*.cu``.

    python -m densereg_torch.tools.trace_summary TRACE_DIR_OR_FILE \\
        [--steps N] [--top K] [--line kernel]

A directory is searched recursively for the newest ``*.pt.trace.json`` or
``*.pt.trace.json.gz``. The columns are ms a step, the share of the total,
calls a step, the kernel id ("-" for any other) and the name.
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys
from typing import Dict, List, Tuple

CATEGORIES = ("kernel", "gpu_memcpy", "cpu_op", "cuda_runtime")
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
# each source's id in PERF.md's kernel table
KERNEL_IDS = {"fused_decode.cu": "K1", "meanshift.cu": "K2",
              "int8_gemm.cu": "K3", "int8_dwconv.cu": "DW"}
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)"
                     r"\s*)?(\w+)")


def kernel_symbols(csrc: str = CSRC) -> Dict[str, str]:
    """``{symbol: id}`` of every ``__global__`` function of the sources in
    ``KERNEL_IDS``."""
    out = {}
    for source, kid in KERNEL_IDS.items():
        with open(os.path.join(csrc, source)) as f:
            for symbol in _GLOBAL.findall(f.read()):
                out[symbol] = kid
    return out


def kernel_id(name: str, symbols: Dict[str, str]) -> str:
    """The id of the port's kernel that ``name`` (a profiler's demangled
    kernel name) launches, "-" for any other."""
    for symbol, kid in symbols.items():
        if re.search(rf"\b{symbol}\b", name):
            return kid
    return "-"


def find_trace(path: str) -> str:
    if os.path.isfile(path):
        return path
    hits = [p for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
            for p in glob.glob(os.path.join(path, "**", pattern),
                               recursive=True)]
    if not hits:
        raise FileNotFoundError(f"no *.pt.trace.json(.gz) under {path}")
    return max(hits, key=os.path.getmtime)   # newest capture


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def summarize(trace: dict, line: str = "kernel"
              ) -> Tuple[List[Tuple[str, float, int]], float, List[str]]:
    """Returns ``(rows, total_us, devices)``: ``rows`` = ``[(name, us,
    count)]`` of the category ``line``, largest first; ``devices`` the
    cards the trace names (``deviceProperties``), or ``["host"]``."""
    agg: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for e in trace["traceEvents"]:
        if e.get("ph") != "X" or e.get("cat") != line:
            continue
        agg[e["name"]] += e.get("dur", 0)
        cnt[e["name"]] += 1
    rows = [(n, us, cnt[n]) for n, us in agg.most_common()]
    devices = [d.get("name", str(d.get("id")))
               for d in trace.get("deviceProperties") or []] or ["host"]
    return rows, sum(agg.values()), devices


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace", help="trace dir (searched recursively) or "
                                  "*.pt.trace.json(.gz) file")
    ap.add_argument("--steps", type=int, default=1,
                    help="number of profiled steps (durations are divided "
                         "by this to report per-step ms)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--line", default="kernel", choices=CATEGORIES,
                    help="event category to aggregate (default: the GPU "
                         "kernels)")
    args = ap.parse_args(argv)

    path = find_trace(args.trace)
    rows, total, devices = summarize(load_trace(path), args.line)
    symbols = kernel_symbols()
    print(f"# {path}")
    print(f"# devices: {devices};  line: {args.line};  "
          f"total {total / args.steps / 1000:.2f} ms/step")
    print(f"{'ms/step':>9}  {'%':>5}  {'calls':>6}  {'id':>3}  op")
    for name, us, n in rows[:args.top]:
        print(f"{us / args.steps / 1000:9.3f}  "
              f"{100 * us / total if total else 0.0:5.1f}  "
              f"{n // args.steps:6d}  {kernel_id(name, symbols):>3}  "
              f"{name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
