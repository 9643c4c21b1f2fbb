from densereg_torch.models.bridge import from_flax, init_variables
from densereg_torch.models.fold import fold_batch_norm
from densereg_torch.models.hourglass import DenseRegNet, Hourglass
from densereg_torch.models.layers import (
    BatchRenorm,
    ConvBR,
    Residual,
    max_pool_same,
    upsample_nearest_2x,
)

__all__ = [
    "BatchRenorm", "ConvBR", "DenseRegNet", "Hourglass", "Residual",
    "fold_batch_norm", "from_flax", "init_variables", "max_pool_same",
    "upsample_nearest_2x",
]
