"""The int8 convolution kernel K3's share of its roofline, %: for each K3
call of a forward of the dispatch's batch, the larger of its bytes over
3.35 TB/s and its int8 operations over 1,979 TOPS, counted from shapes
(``counting_int8.bound_s``), summed over the forward, against K3's device
time a forward (a dispatch runs one) in the traced window. K3's kernels
are found by the ``__global__`` symbols of the program's
``densereg_torch/csrc/int8_gemm.cu``."""

import counting_int8


def read(run):
    return counting_int8.roofline(run, "k3", "int8_gemm.cu")
