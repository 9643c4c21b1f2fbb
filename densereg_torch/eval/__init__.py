from densereg_torch.eval.loop import (
    evaluate_multihost,
    evaluate_stream,
    make_infer_fn,
)
from densereg_torch.eval.metrics import (
    max_joint_error,
    mean_joint_error,
    summarize_percentages,
    threshold_curve,
)
from densereg_torch.eval.writer import (
    ResultWriter,
    read_result_file,
    write_error_curve,
)

__all__ = ["ResultWriter", "evaluate_multihost", "evaluate_stream", "make_infer_fn",
           "max_joint_error", "mean_joint_error", "read_result_file",
           "summarize_percentages", "threshold_curve", "write_error_curve"]
