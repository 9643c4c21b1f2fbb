"""The training step: gradient accumulation over micro-batches.

Mirrors ``densereg_tpu/train/step.py::train_step_single``: the gradients
of the ``sub_batch`` micro-batches are summed (each micro loss sums over
its frames), divided by ``sub_batch``, clipped element-wise and applied
with Adam; the renorm moving statistics and the schedule clock advance
once a micro step. ``make_fused_train_step`` is the same step from raw
frames and poses, the crop included.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from densereg_torch.config import NetConfig, TrainConfig
from densereg_torch.preprocess import preprocess_batch_from_pose
from densereg_torch.train.state import TrainState, loss_fn


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over a list of tensors (``optax.global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def all_reduce_sum_(tensors, group) -> None:
    """Sum each tensor over the ranks of ``group``, in place, in one flat
    all-reduce (one bucket: the gradient of this ~2M-parameter net is a
    few MB)."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               net_cfg: NetConfig, tcfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               with_grads: bool = False,
               mark: Optional[Callable[[str], None]] = None, group=None):
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
      group: a ``torch.distributed`` process group for data parallelism
        (``densereg_tpu/train/step.py``'s explicit path): ``batch`` is this
        rank's slice of the global batch, the net's renorm is synchronized
        over the group (``models.sync_batch_renorm``), and the accumulated
        gradients and the metrics are summed over the ranks in one flat
        all-reduce each, before the division by ``sub_batch`` and the
        clip, so that every rank takes the global batch's step.
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
        loss, metrics = loss_fn(net, mb, net_cfg, tcfg, t, generator, mark,
                                group)
        loss.backward()
        if mark is not None:
            mark("forward_backward")
        per_micro.append(metrics)
        t = t + net_cfg.renorm_t_delta
    named = [(k, p) for k, p in net.named_parameters()]
    params = [p for _, p in named]
    with torch.no_grad():
        grads = [p.grad for p in params]
        if group is not None:
            all_reduce_sum_(grads, group)
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
    names = list(per_micro[0])
    stacked = torch.stack([torch.stack([m[k] for m in per_micro])
                           for k in names])                  # (keys, sub)
    if group is not None:
        all_reduce_sum_([stacked], group)
    out = {k: stacked[i].mean() for i, k in enumerate(names)}
    out["grad_norm"] = grad_norm
    out["param_norm"] = param_norm
    if kept is not None:
        out["grads"] = kept
    return out


def make_fused_train_step(net_cfg: NetConfig, tcfg: TrainConfig, cam_cfg,
                          fixed_bg_threshold: Optional[float] = None):
    """One callable from raw frames to the updated state
    (``densereg_tpu/train/step.py::make_fused_train_step``): the crop,
    center of mass and intrinsics of ``preprocess_batch_from_pose`` on the
    device, the ``(sub_batch, batch, ...)`` layout of ``InputPipeline``,
    then :func:`train_step`; the same computation as the pipeline's crop
    followed by the step.

    Returns ``fn(state, frames, poses, generator=None, with_grads=False)``,
    which updates ``state`` in place and returns the step's metrics (with
    ``with_grads``, the averaged gradient too, as :func:`train_step`):
    ``frames`` are raw ``(sub_batch * batch, H, W, 1)`` depth (uint16 or
    float32 mm), ``poses`` ``(sub_batch * batch, 3J)``, both on the net's
    device. ``cam_cfg`` is the sensor's ``(fx, fy, cx, cy, w, h)``.
    """
    h, w = net_cfg.input_hw
    cam = torch.from_numpy(np.asarray(tuple(cam_cfg), np.float32))
    cams: Dict[torch.device, torch.Tensor] = {}

    def fused(state, frames: torch.Tensor, poses: torch.Tensor,
              generator: Optional[torch.Generator] = None,
              with_grads: bool = False):
        if frames.device not in cams:
            cams[frames.device] = cam.to(frames.device)
        dm, pose, cfgs, coms = preprocess_batch_from_pose(
            frames, poses, cams[frames.device], h, w, fixed_bg_threshold)
        sub = tcfg.sub_batch
        b = dm.shape[0] // sub
        batch = {"dm": dm.reshape(sub, b, h, w, 1),
                 "pose": pose.reshape(sub, b, -1),
                 "cfg": cfgs.reshape(sub, b, 6),
                 "com": coms.reshape(sub, b, 3)}
        return train_step(state, batch, net_cfg, tcfg, generator,
                          with_grads=with_grads)

    return fused
