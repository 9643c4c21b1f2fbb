"""The depthwise int8 kernel DW's share of its roofline, %: for each DW
call of a forward of the dispatch's batch, the larger of its bytes over
3.35 TB/s and its int8 operations over 1,979 TOPS (the bytes set it),
counted from shapes (``counting_int8.bound_s``), summed over the forward,
against DW's device time a forward (a dispatch runs one) in the traced
window. DW's kernels are found by the ``__global__`` symbols of the
program's ``densereg_torch/csrc/int8_dwconv.cu``."""

import counting_int8


def read(run):
    return counting_int8.roofline(run, "dw", "int8_dwconv.cu")
