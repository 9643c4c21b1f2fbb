"""The training step of the reference, plain: the stream of batches a
seeded shuffler draws from the shards, the crop around the pose, and per
step ``sub_batch`` micro-batches of augmentation, targets, the batch-renorm
training forward and the summed L2 loss with weight decay, their gradients
averaged, clipped element-wise and applied by Adam on a staircase rate.

Random draws (augmentation angles and ratios, dropout masks) come from one
``torch.Generator`` in execution order, micro-batch by micro-batch, so that
a run from the same seed on the same device type draws the same numbers.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import augment, net, targets
from .preprocess import norm_dm, preprocess_batch_from_pose


def batch_stream(shard_sizes: Sequence[int], need: int, seed: int,
                 steps: int) -> List[List[Tuple[int, np.ndarray]]]:
    """The first ``steps`` batches of ``need`` frames of a one-producer
    shuffler seeded with ``seed``: shards in a random order, each shard's
    frames in a random order, batches cut from the concatenation. Each
    batch is a list of ``(shard, frame indices)``."""
    rng = np.random.default_rng(seed)
    shards = [i for i, n in enumerate(shard_sizes) if n > 0]
    pool, total, out = [], 0, []
    while len(out) < steps:
        for ri in rng.permutation(len(shards)):
            pool.append((shards[ri], rng.permutation(shard_sizes[shards[ri]])))
            total += len(pool[-1][1])
            while total >= need and len(out) < steps:
                take, left = [], need
                while left:
                    ri_, idxs = pool[0]
                    take.append((ri_, idxs[:left]))
                    if len(idxs) > left:
                        pool[0] = (ri_, idxs[left:])
                    else:
                        pool.pop(0)
                    left -= len(take[-1][1])
                total -= need
                out.append(take)
            if len(out) >= steps:
                break
    return out


def l2_loss(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(torch.square(x))


def micro_loss(cfg: dict, tcfg: dict, params, stats, batch, t: torch.Tensor,
               generator: torch.Generator, dtype=torch.float32,
               round_operands=None):
    """The total loss of one micro-batch ``(dm, pose, cfgs, coms)``."""
    dms, poses, cfgs, coms = batch
    dms, poses = augment.augment_batch(dms, poses, cfgs, coms, generator)
    out_h, out_w = dms.shape[1] // 4, dms.shape[2] // 4
    normed = norm_dm(dms, coms)
    gt = targets.synthesize(poses, cfgs, coms, normed, out_h, out_w)
    r_max, d_max = net.renorm_clip_schedule(t)
    ctx = net.Ctx(params, "train", dtype, stats, r_max, d_max, generator,
                  dropout_rate=tcfg["dropout_rate"],
                  round_operands=round_operands)
    outs = net.forward(ctx, cfg, normed)
    hm_loss = sum(l2_loss(est - gt["hm2"]) for est in outs["hm"])
    hm3_loss = sum(l2_loss(est - gt["hm3"]) for est in outs["hm3"])
    um_loss = sum(l2_loss(est - gt["um"]) for est in outs["um"])
    reg = torch.stack([l2_loss(p) for k, p in params.items()
                       if k.endswith("/conv/kernel")
                       and not k.startswith("inter_")]).sum()
    return hm_loss + hm3_loss + um_loss + tcfg["weight_decay"] * reg


class Adam:
    """Element-wise clip to ``[-clip, clip]``, then Adam, with the bias
    correction in float32; the rate ``init_lr * factor ** (count //
    decay_steps)`` of the update count before this update."""

    def __init__(self, params: Dict[str, torch.Tensor], tcfg: dict):
        self.b1, self.b2, self.eps = tcfg["adam_beta1"], 0.999, 1e-8
        self.clip = tcfg["grad_clip_value"]
        self.lr, self.factor = tcfg["init_lr"], tcfg["lr_decay_factor"]
        self.decay_steps = max(int(tcfg["decay_steps"]), 1)
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        t = np.float32(self.count + 1)
        bc1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        lr = self.lr * self.factor ** (self.count // self.decay_steps)
        for k, p in params.items():
            g = grads[k].clamp(-self.clip, self.clip)
            self.mu[k] = self.mu[k] * self.b1 + g * (1.0 - self.b1)
            self.nu[k] = self.nu[k] * self.b2 + (g * g) * (1.0 - self.b2)
            denom = torch.sqrt(self.nu[k] / bc2) + self.eps
            p.add_((self.mu[k] / bc1) / denom * float(np.float32(-lr)))
        self.count += 1


def train_steps(cfg: dict, tcfg: dict, params0: Dict[str, torch.Tensor],
                stats0: Dict[str, torch.Tensor], shards, cam: torch.Tensor,
                seed: int, steps: int, device, dtype=torch.float32,
                round_operands=None, fault=None, tf32: bool = False):
    """``steps`` training steps from ``params0``/``stats0`` (moved to
    ``device`` and copied) on the stream of :func:`batch_stream` over
    ``shards`` (a list of ``(depth (n, H, W) uint16, pose (n, 3j))``
    arrays), with the generator seeded ``seed``. ``round_operands``
    (``net.Ctx``) or ``tf32`` (the libraries' TF32 switched on) makes it a
    control in a lower precision; ``fault="half"``
    a planted fault: each micro-batch's second half left out, its loss
    doubled.

    Returns ``{"loss": [per step], "grad1": averaged gradient of step 1,
    "clipped1": the same after the clip, "params": after the steps,
    "stats": after the steps}``."""
    b, sub, size = tcfg["batch_size"], tcfg["sub_batch"], cfg["input_size"]
    params = {k: v.detach().to(device).clone().requires_grad_(True)
              for k, v in params0.items()}
    stats = {k: v.detach().to(device).clone() for k, v in stats0.items()}
    opt = Adam(params, tcfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    cam = cam.to(device)
    t = torch.zeros((), dtype=torch.float32)
    out = {"loss": []}
    order = batch_stream([len(s[0]) for s in shards], b * sub, seed, steps)
    with net.tf32_switch(tf32):
        for step, take in enumerate(order):
            depth = np.concatenate([shards[r][0][ix] for r, ix in take])
            pose = np.concatenate([shards[r][1][ix] for r, ix in take])
            dm, pose, cfgs, coms = preprocess_batch_from_pose(
                torch.from_numpy(depth[..., None]).to(device),
                torch.from_numpy(pose.astype(np.float32)).to(device), cam,
                size, size, tcfg["fixed_bg_threshold"])
            for p in params.values():
                p.grad = None
            losses = []
            for i in range(sub):
                rows = slice(i * b,
                             i * b + (b // 2 if fault == "half" else b))
                loss = micro_loss(cfg, tcfg, params, stats,
                                  (dm[rows], pose[rows], cfgs[rows],
                                   coms[rows]), t, gen, dtype, round_operands)
                if fault == "half":
                    loss = 2.0 * loss
                loss.backward()
                losses.append(loss.detach())
                t = t + tcfg["renorm_t_delta"]
            grads = {k: p.grad / float(sub) for k, p in params.items()}
            if step == 0:
                out["grad1"] = {k: g.clone() for k, g in grads.items()}
                out["clipped1"] = {k: g.clamp(-opt.clip, opt.clip)
                                   for k, g in grads.items()}
            opt.step(params, grads)
            out["loss"].append(float(torch.stack(losses).mean()))
    out["params"] = {k: p.detach() for k, p in params.items()}
    out["stats"] = stats
    return out
