"""Loss and regularizer vocabulary of ``densereg_tpu/train/losses.py``.

The trainer uses :func:`l2_loss` (the data term, ``loss_type="l2"``),
:func:`l1_loss` (``loss_type="l1"``) and :func:`l2_regularizer` (the conv
kernels' weight decay). Every term sums over its elements; none averages.
"""

from __future__ import annotations

import torch


def l2_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """``weight * sum(x^2) / 2`` (``tf.nn.l2_loss``)."""
    return weight * 0.5 * torch.sum(torch.square(x))


def l1_loss(x: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """``weight * sum(|x|)``."""
    return weight * torch.sum(torch.abs(x))


def l1_regularizer(weight: float = 1.0):
    return lambda t: weight * torch.sum(torch.abs(t))


def l2_regularizer(weight: float = 1.0):
    return lambda t: weight * 0.5 * torch.sum(torch.square(t))


def l1_l2_regularizer(weight_l1: float = 1.0, weight_l2: float = 1.0):
    return lambda t: (weight_l1 * torch.sum(torch.abs(t))
                      + weight_l2 * 0.5 * torch.sum(torch.square(t)))


def cross_entropy_loss(logits: torch.Tensor, one_hot_labels: torch.Tensor,
                       label_smoothing: float = 0.0,
                       weight: float = 1.0) -> torch.Tensor:
    """Softmax cross entropy with label smoothing, probabilities clipped at
    1e-10 before the log, averaged over the batch."""
    n_classes = one_hot_labels.shape[-1]
    if label_smoothing > 0:
        one_hot_labels = (one_hot_labels * (1.0 - label_smoothing)
                          + label_smoothing / n_classes)
    e = torch.exp(logits - torch.amax(logits, -1, keepdim=True))
    log_p = torch.log(torch.clamp(e / torch.sum(e, -1, keepdim=True), 1e-10))
    ce = -torch.sum(one_hot_labels * log_p, dim=-1)
    return weight * torch.mean(ce)
