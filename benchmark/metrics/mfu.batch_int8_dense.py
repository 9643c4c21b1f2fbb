"""The whole int8 serving step's share of the chip's int8 peak in the
calibrated int8 ``um_v1`` cell, %: the net's int8 operations a frame
(``counting_int8_dense.forward_ops``) times the frames the traced window
completed, over the window's length times 1,979 TOPS (dense)."""

import counting_int8_dense


def read(run):
    if run.trace is None or not run.counts.get("frames"):
        return None
    ops = counting_int8_dense.forward_ops(run.config) * run.counts["frames"]
    return 100.0 * ops / (run.trace.window_s
                          * counting_int8_dense.PEAK_INT8_OPS)
