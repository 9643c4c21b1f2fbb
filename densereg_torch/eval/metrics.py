"""Pose-error metrics, as ``densereg_tpu/eval/metrics.py``: the per-frame
errors in torch (on the device the poses lie on), the threshold curve and
the report in numpy on the host."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def _joint_dists(pred, gt) -> torch.Tensor:
    d = torch.as_tensor(pred) - torch.as_tensor(gt)
    return torch.linalg.vector_norm(d.reshape(d.shape[:-1] + (-1, 3)),
                                    dim=-1)


def max_joint_error(pred, gt) -> torch.Tensor:
    """Per-frame max over joints of the euclidean error; ``(..., 3j)``."""
    return _joint_dists(pred, gt).amax(dim=-1)


def mean_joint_error(pred, gt) -> torch.Tensor:
    """Per-frame mean over joints of the euclidean error."""
    return _joint_dists(pred, gt).mean(dim=-1)


THRESHOLDS_MM = [t * 5.0 + 0.5 for t in range(17)]


def threshold_curve(scores: Sequence[float]) -> Tuple[List[float], List[float]]:
    """Fraction of frames with max-joint-error < tau for tau in 0.5 + 5k mm."""
    s = np.sort(np.asarray(scores, np.float64))
    n = max(len(s), 1)
    fractions = [float(np.sum(s < t)) / n for t in THRESHOLDS_MM]
    return list(THRESHOLDS_MM), fractions


def summarize_percentages(scores: Sequence[float]) -> dict:
    """Fraction of frames within 10/20/30/40 mm (+0.5)."""
    s = np.asarray(scores, np.float64)
    n = max(len(s), 1)
    return {f"{m}mm": float(np.sum(s <= m + 0.5)) / n for m in (10, 20, 30, 40)}
