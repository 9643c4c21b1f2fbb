from densereg_torch.models.bridge import (
    act_stats_to_flax,
    from_flax,
    init_train_variables,
    init_variables,
    to_flax,
)
from densereg_torch.models.fold import fold_batch_norm
from densereg_torch.models.hourglass import (
    DenseRegNet,
    Hourglass,
    renorm_clip_schedule,
)
from densereg_torch.models.layers import (
    BatchRenorm,
    ConvBR,
    QTensor,
    Residual,
    as_float,
    max_pool_same,
    sync_batch_renorm,
    upsample_nearest_2x,
)
from densereg_torch.models.quantize import (
    calibrate,
    quantize_weights,
    quantized_net_config,
)

__all__ = [
    "BatchRenorm", "ConvBR", "DenseRegNet", "Hourglass", "QTensor",
    "Residual", "act_stats_to_flax", "as_float", "calibrate",
    "fold_batch_norm", "from_flax", "init_train_variables",
    "init_variables", "max_pool_same", "quantize_weights",
    "quantized_net_config", "renorm_clip_schedule", "sync_batch_renorm",
    "to_flax",
    "upsample_nearest_2x",
]
