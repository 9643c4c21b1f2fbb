"""The int8 convolution kernel K3's share of its roofline in the calibrated
int8 ``um_v1`` cell, %: for each of the forward's 146 K3 calls at the
dispatch's batch, the larger of its bytes over 3.35 TB/s and its int8
operations over 1,979 TOPS, counted from shapes
(``counting_int8_dense.bound_s``), summed over the forward, against K3's
device time a forward (a dispatch runs one) in the traced window. K3's
kernels are found by the ``__global__`` symbols of the program's
``densereg_torch/csrc/int8_gemm.cu``."""

import counting_int8_dense


def read(run):
    return counting_int8_dense.roofline(run)
