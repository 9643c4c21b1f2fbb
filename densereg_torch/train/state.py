"""Train state and loss.

Mirrors ``densereg_tpu/train/state.py``: the state is the net (parameters
and the renorm moving statistics as buffers), the optimizer (an
element-wise gradient clip, then Adam on a staircase schedule), the update
count, the renorm schedule clock and the optional weight EMA.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from densereg_torch import augment, targets
from densereg_torch.config import NetConfig, TrainConfig
from densereg_torch.models import (
    DenseRegNet,
    from_flax,
    init_train_variables,
    renorm_clip_schedule,
)
from densereg_torch.models.layers import BatchRenorm
from densereg_torch.preprocess import norm_dm
from densereg_torch.train import losses as loss_lib
from densereg_torch.train.lr import staircase_exponential_decay
from densereg_torch.utils.profiling import span


class ClippedAdam(torch.optim.Optimizer):
    """Clip every gradient element to ``[-clip, clip]``, then an Adam step
    with the learning rate ``schedule(count)``, ``count`` the number of
    updates made before this one: ``optax.chain(optax.clip(clip),
    optax.adam(schedule, b1, b2, eps))``, operation for operation. Like
    optax it corrects the bias in float32 (``1 - b2**t`` with b2 rounded to
    float32 first, which is 1.3e-5 off 0.001 at t = 1), where
    ``torch.optim.Adam`` does so in double. The moments live in the state
    of each parameter, the count in the parameter group, so both are saved
    and restored with ``state_dict``."""

    def __init__(self, params, schedule: Callable[[int], float], clip: float,
                 betas=(0.5, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(betas=betas, eps=eps, count=0))
        self.schedule = schedule
        self.clip = clip

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            count = group["count"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            torch._foreach_clamp_min_(grads, -self.clip)
            torch._foreach_clamp_max_(grads, self.clip)
            for p in params:
                if not self.state[p]:
                    self.state[p]["mu"] = torch.zeros_like(p)
                    self.state[p]["nu"] = torch.zeros_like(p)
            mus = [self.state[p]["mu"] for p in params]
            nus = [self.state[p]["nu"] for p in params]
            # moments: (1 - b) * g + b * m, in float32
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - b2))
            t = np.float32(count + 1)
            bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
            bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mus, bc1), denom)
            torch._foreach_mul_(upd, float(np.float32(-self.schedule(count))))
            torch._foreach_add_(params, upd)
            group["count"] = count + 1


def make_optimizer(params, tcfg: TrainConfig,
                   steps_per_epoch: float) -> ClippedAdam:
    """Adam (beta1 ``tcfg.adam_beta1``, beta2 0.999, eps 1e-8) on the
    staircase-decayed learning rate, after an element-wise clip of the
    (accumulated, averaged) gradients to ``tcfg.grad_clip_value``."""
    decay_steps = int(steps_per_epoch * tcfg.epochs_per_decay)
    schedule = staircase_exponential_decay(tcfg.init_lr, decay_steps,
                                           tcfg.lr_decay_factor)
    return ClippedAdam(params, schedule, tcfg.grad_clip_value,
                       betas=(tcfg.adam_beta1, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The net (in training mode), its optimizer, the update count, the
    renorm schedule clock (a 0-d float32 CPU tensor, advanced in float32
    as the JAX package does), the EMA of the parameters (None unless
    ``TrainConfig.ema_decay`` is set) and the CUDA graphs of the net's
    micro-batches (``train.step.MicroBatchGraph``, by shapes), which live
    as long as the state."""

    net: DenseRegNet
    optimizer: ClippedAdam
    step: int = 0
    renorm_t: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.zeros((), dtype=torch.float32))
    ema: Optional[Dict[str, torch.Tensor]] = None
    graphs: dict = dataclasses.field(default_factory=dict, repr=False)


def create_train_state(net_cfg: NetConfig, tcfg: TrainConfig,
                       steps_per_epoch: float, variables=None,
                       device="cuda") -> TrainState:
    """A fresh state on ``device``: the net from ``variables`` (a Flax-layout
    ``{"params", "batch_stats"}`` tree; by default the training init drawn
    from ``tcfg.seed``, ``models.init_train_variables``)."""
    if variables is None:
        variables = init_train_variables(net_cfg, tcfg.seed)
    net = from_flax(variables, net_cfg).to(device).train()
    opt = make_optimizer(net.parameters(), tcfg, steps_per_epoch)
    ema = None
    if tcfg.ema_decay is not None:
        ema = {k: p.detach().clone() for k, p in net.named_parameters()}
    return TrainState(net=net, optimizer=opt, ema=ema)


def weight_decay_loss(net: torch.nn.Module,
                      weight_decay: float) -> torch.Tensor:
    """``weight_decay * sum(w^2) / 2`` over the convolution kernels only
    (biases, gamma and beta are exempt), skipping the inter-stack
    re-injection convolutions (``inter_*``), which the reference creates
    without weight decay."""
    reg = loss_lib.l2_regularizer(1.0)
    terms = [reg(p.float()) for name, p in net.named_parameters()
             if name.endswith(".kernel")
             and not any(part.startswith("inter_")
                         for part in name.split("."))]
    return weight_decay * torch.stack(terms).sum()


def remat_forward(net: DenseRegNet, normed: torch.Tensor, r_max, d_max,
                  generator: Optional[torch.Generator] = None):
    """The training forward rematerialised (``NetConfig.remat``, the JAX
    package's ``jax.checkpoint`` around the whole forward): no activation
    is kept for the backward pass, which runs the forward again
    (``torch.utils.checkpoint``, non-reentrant).

    The recompute must be the first pass again and change nothing: every
    batch renorm takes ``r`` and ``d`` from the moving statistics as they
    stood before the first pass and does not move them
    (``BatchRenorm.replay``), and the dropout masks are drawn again from
    ``generator`` at the state it had before the first pass, which is then
    set back to where the first pass left it."""
    renorms = [m for m in net.modules() if isinstance(m, BatchRenorm)]
    before = [(m.mean.clone(), m.var.clone()) for m in renorms]
    gen_before = None if generator is None else generator.get_state()
    passes = []

    def run(x):
        recompute = bool(passes)
        passes.append(True)
        if not recompute:
            return net(x, r_max, d_max, generator)
        gen_after = None if generator is None else generator.get_state()
        for m, stats in zip(renorms, before):
            m.replay = stats
        if generator is not None:
            generator.set_state(gen_before)
        try:
            return net(x, r_max, d_max, generator)
        finally:
            for m in renorms:
                m.replay = None
            if generator is not None:
                generator.set_state(gen_after)

    return checkpoint(run, normed, use_reentrant=False)


def renorm_clip_bounds(renorm_t) -> np.ndarray:
    """Batch renorm's clip ranges at the clock ``renorm_t`` as float32
    ``[1/r_max, r_max, -d_max, d_max]``: ``renorm_clip_schedule``'s values
    rounded as ``BatchRenorm`` rounds the float bounds it clamps at, for
    its tensor form (``(low, high)`` pairs)."""
    r_max, d_max = renorm_clip_schedule(renorm_t)
    return np.array([1.0 / r_max, r_max, -d_max, d_max], np.float32)


def augment_targets(batch: Dict[str, torch.Tensor], net_cfg: NetConfig,
                    tcfg: TrainConfig,
                    generator: Optional[torch.Generator] = None):
    """The part of :func:`loss_fn` before the net, in the span
    ``densereg.train.augment_targets``: the augmentation (with
    ``tcfg.augment``, drawn from ``generator``), ``norm_dm`` and
    ``targets.synthesize``. Returns ``(normed, gt)``."""
    dms, poses = batch["dm"], batch["pose"]
    cfgs, coms = batch["cfg"], batch["com"]
    out_h, out_w = net_cfg.output_hw
    with span("densereg.train.augment_targets"):
        if tcfg.augment:
            dms, poses = augment.augment_batch(dms, poses, cfgs, coms,
                                               generator)
        normed = norm_dm(dms, coms)
        gt = targets.synthesize(poses, cfgs, coms, normed, out_h, out_w)
    return normed, gt


def forward_loss(net: DenseRegNet, normed: torch.Tensor,
                 gt: Dict[str, torch.Tensor], net_cfg: NetConfig,
                 tcfg: TrainConfig, r_max, d_max,
                 generator: Optional[torch.Generator] = None, group=None):
    """The part of :func:`loss_fn` from the net on: the training forward
    with the renorm clip bounds ``r_max``/``d_max`` (floats, or
    ``BatchRenorm``'s ``(low, high)`` tensor pairs) and the dropout masks
    drawn from ``generator``, the data terms against ``gt``'s ``hm2``,
    ``hm3`` and ``um``, and the weight decay. Returns ``(total,
    metrics)``, metrics detached."""
    if net_cfg.remat:
        outs = remat_forward(net, normed, r_max, d_max, generator)
    else:
        outs = net(normed, r_max, d_max, generator)
    data_loss = (loss_lib.l2_loss if tcfg.loss_type == "l2"
                 else loss_lib.l1_loss)
    hm_loss = sum(data_loss(est - gt["hm2"]) for est in outs["hm"])
    hm3_loss = sum(data_loss(est - gt["hm3"]) for est in outs["hm3"])
    um_loss = sum(data_loss(est - gt["um"]) for est in outs["um"])
    reg_loss = weight_decay_loss(net, tcfg.weight_decay)
    if group is not None:
        import torch.distributed as dist

        reg_loss = reg_loss / float(dist.get_world_size(group))
    total = hm_loss + hm3_loss + um_loss + reg_loss
    metrics = {"loss": total, "hm_loss": hm_loss, "hm3_loss": hm3_loss,
               "um_loss": um_loss, "reg_loss": reg_loss}
    return total, {k: v.detach() for k, v in metrics.items()}


def loss_fn(net: DenseRegNet, batch: Dict[str, torch.Tensor],
            net_cfg: NetConfig, tcfg: TrainConfig, renorm_t,
            generator: Optional[torch.Generator] = None, group=None):
    """Total training loss of one micro-batch: :func:`augment_targets`,
    then :func:`forward_loss` at the renorm clock ``renorm_t``.

    ``batch``: ``dm (b, H, W, 1)`` raw mm, ``pose (b, 3j)``, ``cfg (b, 6)``,
    ``com (b, 3)``. With ``tcfg.augment`` the batch is augmented first;
    ``generator`` draws the augmentation and the dropout masks. Data terms
    are ``sum(x^2)/2`` (``sum|x|`` for ``l1``) over every stack's heads,
    summed, never averaged; the weight decay is part of every micro loss.
    The augmentation and the targets are the span
    ``densereg.train.augment_targets``. With ``group`` (data parallelism) the batch is this
    rank's slice and the weight decay is divided by the group's size, so
    that the ranks' losses sum to the global batch's, as the JAX loss does
    under ``axis_name``. Returns ``(total, metrics)``, metrics detached.
    """
    normed, gt = augment_targets(batch, net_cfg, tcfg, generator)
    r_max, d_max = renorm_clip_schedule(renorm_t)
    return forward_loss(net, normed, gt, net_cfg, tcfg, r_max, d_max,
                        generator, group)
