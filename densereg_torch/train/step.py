"""The training step: gradient accumulation over micro-batches.

Mirrors ``densereg_tpu/train/step.py::train_step_single``: the gradients
of the ``sub_batch`` micro-batches are summed (each micro loss sums over
its frames), divided by ``sub_batch``, clipped element-wise and applied
with Adam; the renorm moving statistics and the schedule clock advance
once a micro step.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from densereg_torch.config import NetConfig, TrainConfig
from densereg_torch.train.state import TrainState, loss_fn


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over a list of tensors (``optax.global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               net_cfg: NetConfig, tcfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               with_grads: bool = False,
               mark: Optional[Callable[[str], None]] = None):
    """One optimizer step, in place on ``state``.

    Args:
      batch: ``dm``, ``pose``, ``cfg``, ``com`` with leading ``(sub_batch,
        batch)`` axes, on the net's device.
      generator: draws augmentation and dropout (on the net's device).
      with_grads: also return the averaged gradient (before the clip) as
        ``metrics["grads"]``, keyed like the net's parameters.
      mark: called with a phase name as each phase's work is issued:
        ``"augment_targets"`` and ``"forward_backward"`` once a micro step,
        ``"optimizer"`` after the update.
    Returns:
      metrics: 0-d tensors on the device, the losses averaged over the
      micro steps, plus ``grad_norm`` (of the averaged gradient, before the
      clip) and ``param_norm`` (after the update).
    """
    net = state.net
    sub = batch["dm"].shape[0]
    state.optimizer.zero_grad(set_to_none=True)
    per_micro = []
    t = state.renorm_t
    for i in range(sub):
        mb = {k: v[i] for k, v in batch.items()}
        loss, metrics = loss_fn(net, mb, net_cfg, tcfg, t, generator, mark)
        loss.backward()
        if mark is not None:
            mark("forward_backward")
        per_micro.append(metrics)
        t = t + net_cfg.renorm_t_delta
    named = [(k, p) for k, p in net.named_parameters()]
    params = [p for _, p in named]
    with torch.no_grad():
        grads = [p.grad for p in params]
        torch._foreach_div_(grads, float(sub))
        grad_norm = global_norm(grads)
        kept = ({k: p.grad.clone() for k, p in named} if with_grads
                else None)
        state.optimizer.step()
        param_norm = global_norm(params)
        if state.ema is not None and tcfg.ema_decay is not None:
            d = tcfg.ema_decay
            for k, p in named:
                e = state.ema[k]
                e.copy_(e * d + p * (1.0 - d))
    if mark is not None:
        mark("optimizer")
    state.step += 1
    state.renorm_t = t
    out = {k: torch.stack([m[k] for m in per_micro]).mean()
           for k in per_micro[0]}
    out["grad_norm"] = grad_norm
    out["param_norm"] = param_norm
    if kept is not None:
        out["grads"] = kept
    return out
