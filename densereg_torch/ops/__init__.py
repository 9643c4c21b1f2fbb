"""Hand-written CUDA kernels of the port, each beside its plain version."""

from densereg_torch.ops.meanshift import weighted_mean_shift_cuda

__all__ = ["weighted_mean_shift_cuda"]
