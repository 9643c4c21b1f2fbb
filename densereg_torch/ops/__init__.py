"""Hand-written CUDA kernels of the port, each beside its plain version.

Importing this package registers every kernel as a ``torch.library`` custom
op in the ``densereg`` namespace (``torch.ops.densereg.*``), which is all
that loading an exported program (``densereg_torch.export``) needs of the
port: ``fused_decode`` (K1), ``weighted_mean_shift`` (K2),
``int8_gemm_requant`` and ``int8_conv_requant`` (K3's two entries),
``int8_dwconv_requant`` and ``int8_quantize``.
"""

# the submodules register the ops; their names stay the modules'
from densereg_torch.ops import fused_decode  # noqa: F401
from densereg_torch.ops import int8_dwconv  # noqa: F401
from densereg_torch.ops import int8_gemm  # noqa: F401
from densereg_torch.ops import int8_quantize  # noqa: F401
from densereg_torch.ops import meanshift  # noqa: F401
from densereg_torch.ops.meanshift import weighted_mean_shift_cuda

OP_NAMES = ("fused_decode", "weighted_mean_shift", "int8_gemm_requant",
            "int8_conv_requant", "int8_dwconv_requant", "int8_quantize")

__all__ = ["OP_NAMES", "weighted_mean_shift_cuda"]
