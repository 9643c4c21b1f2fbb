"""densereg_torch: the PyTorch / CUDA port of densereg_tpu.

The same system as ``densereg_tpu`` (crop, stacked-hourglass dense
regression, vote decode, training in ``densereg_torch.train``), in
PyTorch, with the TPU kernels rewritten by hand for NVIDIA Hopper under
``csrc/``. It imports neither JAX nor the JAX
package. Entry points run on CUDA unless given ``device="cpu"``.
"""

from densereg_torch.config import CameraConfig, EvalConfig, NetConfig

__all__ = ["CameraConfig", "EvalConfig", "NetConfig", "Predictor"]


def __getattr__(name):
    # Predictor is imported on first use: the package's import stays free
    # of the model code, which a loaded export artifact does not need
    if name == "Predictor":
        from densereg_torch.serving import Predictor

        return Predictor
    raise AttributeError(f"module 'densereg_torch' has no attribute {name!r}")
