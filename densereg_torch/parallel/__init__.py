from densereg_torch.parallel.distributed import initialize_distributed
from densereg_torch.parallel.mesh import (
    Mesh,
    Sharding,
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch,
)

__all__ = [
    "Mesh",
    "Sharding",
    "batch_sharding",
    "initialize_distributed",
    "make_mesh",
    "replicated_sharding",
    "shard_batch",
]
