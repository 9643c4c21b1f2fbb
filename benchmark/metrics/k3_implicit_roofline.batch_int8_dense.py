"""K3's implicit-GEMM entry (``ops/int8_gemm.py::int8_conv_requant``: the
41 bottleneck 3x3s and the 7x7/2 stem of ``um_v1``) against its roofline,
%: those 42 calls' least time a forward at the dispatch's batch
(``counting_int8_dense.bound_s``) over their device time a forward. K3's
kernel records are grouped by the ``cudaGraphLaunch`` that ran them, one
group a replayed forward, and each complete group's i-th record, by start
time, is the forward's i-th K3 call (``counting_int8_dense.calls``); a
group that lacks a record is skipped, and without a complete one the
metric is None."""

import counting_int8_dense


def read(run):
    return counting_int8_dense.implicit_roofline(run)
