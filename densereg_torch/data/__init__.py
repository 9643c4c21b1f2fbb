from densereg_torch.data.base import (
    DatasetSpec,
    ShardReader,
    ShardWriter,
    get_dataset,
)
from densereg_torch.data.pipeline import InputPipeline, TestPipeline

__all__ = [
    "DatasetSpec",
    "ShardWriter",
    "ShardReader",
    "get_dataset",
    "InputPipeline",
    "TestPipeline",
]
