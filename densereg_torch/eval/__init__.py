from densereg_torch.eval.loop import make_infer_fn
from densereg_torch.eval.metrics import (
    max_joint_error,
    mean_joint_error,
    summarize_percentages,
    threshold_curve,
)

__all__ = ["make_infer_fn", "max_joint_error", "mean_joint_error",
           "summarize_percentages", "threshold_curve"]
