"""densereg_torch: the PyTorch / CUDA port of densereg_tpu.

The same system as ``densereg_tpu`` (crop, stacked-hourglass dense
regression, vote decode, training in ``densereg_torch.train``), in
PyTorch, with the TPU kernels rewritten by hand for NVIDIA Hopper under
``csrc/``. It imports neither JAX nor the JAX
package. Entry points run on CUDA unless given ``device="cpu"``.
"""

from densereg_torch.config import CameraConfig, EvalConfig, NetConfig
from densereg_torch.serving import Predictor

__all__ = ["CameraConfig", "EvalConfig", "NetConfig", "Predictor"]
