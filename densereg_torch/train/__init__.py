from densereg_torch.train.checkpoint import CheckpointManager
from densereg_torch.train.loop import BestTracker, rotating_batches, train
from densereg_torch.train.lr import staircase_exponential_decay
from densereg_torch.train.state import (
    ClippedAdam,
    TrainState,
    create_train_state,
    loss_fn,
    make_optimizer,
    weight_decay_loss,
)
from densereg_torch.train.step import (
    global_norm,
    make_fused_train_step,
    train_step,
)

__all__ = [
    "BestTracker",
    "CheckpointManager",
    "ClippedAdam",
    "TrainState",
    "create_train_state",
    "global_norm",
    "loss_fn",
    "make_fused_train_step",
    "make_optimizer",
    "rotating_batches",
    "staircase_exponential_decay",
    "train",
    "train_step",
    "weight_decay_loss",
]
