"""The decode kernel K1's share of its roofline, %: the bytes one decode
call needs, counted from shapes (``counting.decode_bytes``), over the
H100's 3.35 TB/s, against K1's device time a call in the traced window.
K1's kernels are found by the ``__global__`` symbols of the program's
``densereg_torch/csrc/fused_decode.cu``."""

import os
import re

import common
import counting
import devtrace


def read(run):
    if run.trace is None:
        return None
    src = os.path.join(common.CHECKOUT, "densereg_torch", "csrc",
                       "fused_decode.cu")
    symbols = devtrace.kernel_symbols(src)
    calls = run.trace.events(
        "kernel", "|".join(rf"\b{re.escape(s)}\b" for s in symbols))
    if not calls:
        return None
    per_call = sum(e.get("dur", 0) for e in calls) / 1e6 / len(calls)
    cfg = run.config
    need = counting.decode_bytes(run.counts["decode_batch"],
                                 cfg["num_joint"], cfg["input_size"] // 4)
    return 100.0 * need / counting.PEAK_BYTES_PER_S / per_call
