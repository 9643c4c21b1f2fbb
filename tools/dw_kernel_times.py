#!/usr/bin/env python3
"""The depthwise int8 kernel (``csrc/int8_dwconv.cu``) on the card: what
ptxas made of it, its SASS by opcode, and its time at every distinct call of
the two int8 ``um_v1_lite`` nets, against its plain version.

    python3 tools/dw_kernel_times.py [--tree DIR] [--label NAME] [--iters N]

``--tree`` imports ``densereg_torch`` from another checkout (default: this
one), so that two versions of the kernel can be timed in one call on one
card: unpack the other commit with ``git archive`` into a git-ignored
directory and run the script once per tree, in turns. The scenes, timers
and bounds are this checkout's ``chip_smoke.py``'s. Prints JSON lines:

- ``ptxas``: registers, spill bytes and stack of each ``dw_kernel``
  instantiation (``nvcc -Xptxas -v`` on the tree's source
  with the tree's flags);
- ``sass``: each instantiation's instruction count by opcode
  (``cuobjdump -sass``), where the toolkit has ``cuobjdump``;
- ``chip_smoke.phase_kernel_dwconv``'s rows on the tree's kernel: every
  distinct call of the calibrated (``q`` out) and the dynamic (bfloat16
  ``f`` out) lite int8 nets at batch 256 (``device_ms`` by the profiler,
  ``host_us``, ``bound_ms``, ``q_mismatches``, ``f_max_ulps``) and the
  per-forward totals;
- ``chip_smoke.phase_dw_scenes``' rows: each window size at the largest
  lite call, and the requantisation ties.

Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                   r"([A-Z][A-Z0-9_]*)")


def demangle(names):
    """``{mangled: readable}`` by ``c++filt`` where it exists."""
    names = list(names)
    tool = shutil.which("c++filt")
    if tool is None or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), text=True,
                         capture_output=True, check=True).stdout.split("\n")
    return dict(zip(names, out))


def sass_histogram(text: str):
    """``{function: Counter(opcode)}`` from ``cuobjdump -sass`` output."""
    hist, func = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            func = m.group(1)
            hist[func] = collections.Counter()
            continue
        m = _INSN.match(line)
        if m and func is not None:
            hist[func][m.group(1)] += 1
    return hist


def build_report(build, ptxas_usage, out_dir: str):
    """Compile ``csrc/int8_dwconv.cu`` of the tree with its own flags plus
    ``-Xptxas -v``; returns ``(ptxas_usage of the log, sass histogram or
    None)``."""
    nvcc = build.nvcc_path()
    src = build.sources()["int8_dwconv"]
    lib = os.path.join(out_dir, "libint8_dwconv_report.so")
    log = subprocess.run(
        [nvcc, *build.flags("int8_dwconv"), "-Xptxas", "-v", "-o", lib,
         str(src)], capture_output=True, text=True, check=True)
    usage = ptxas_usage(log.stdout + log.stderr)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    hist = None
    if os.path.isfile(cuobjdump):
        sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        hist = sass_histogram(sass)
    return usage, hist


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--label", default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    # this checkout's chip_smoke, on the densereg_torch of --tree
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables
    from densereg_torch.ops import _build
    from densereg_torch.ops import int8_dwconv as dw

    # older trees: no build log, launch plan or staging predicate
    if not hasattr(_build, "build_log"):
        _build.build_log = lambda name: None
    if not hasattr(dw, "plan_launch"):
        cs.dw_plan = lambda key: None
    if not hasattr(dw, "tensor_map_path"):
        dw.tensor_map_path = lambda x: x.stride(2) % 16 == 0
    if not torch.cuda.is_available():
        print("dw_kernel_times: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    label = args.label or os.path.basename(os.path.abspath(args.tree))
    cs.emit({"tool": "dw_kernel_times", "label": label,
             "package": os.path.dirname(dw.__file__),
             "nvidia_smi": cs.gpu_name_and_power(),
             "torch": torch.__version__, "cuda": torch.version.cuda})
    with tempfile.TemporaryDirectory(prefix="dw_report_") as tmp:
        usage, hist = build_report(_build, cs.ptxas_usage, tmp)
    names = demangle(set(usage) | set(hist or {}))
    for mangled, u in sorted(usage.items()):
        cs.emit({"label": label, "ptxas": names[mangled], **u})
    for mangled, h in sorted((hist or {}).items()):
        cs.emit({"label": label, "sass": names[mangled],
                 "instructions": sum(h.values()),
                 "by_opcode": dict(h.most_common())})
    if hist is None:
        cs.emit({"label": label, "sass": None, "reason": "no cuobjdump"})
    _build.build(["int8_dwconv"])

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(NetConfig(), net_module="um_v1_lite")
    variables = init_variables(cfg, seed=cs.SEED)
    totals = cs.phase_kernel_dwconv(variables, cfg, "cuda",
                                    iters=args.iters)
    for kind, total in totals.items():
        cs.emit({"label": label, "net": kind,
                 **{k: total[k] for k in ("device_ms", "bound_ms",
                                          "share_of_bound", "host_us_mean")}})
    cs.phase_dw_scenes("cuda", iters=args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
