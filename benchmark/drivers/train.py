"""Training: the window is one call of the program's ``train.loop.train``
at the traffic's batch, augmentation on, every cadence at its default,
resumed (``restore_step="auto"``) from the checkpoint that set-up's call
left after the first steps.

Set-up renders a seeded pool of frames at the configuration's camera and
writes it through the program's shard writer, makes the training init on
the device and writes it as a converted payload, and calls ``train`` for
the first ``checked_steps`` steps from that payload. The window's call
resumes from set-up's checkpoint; its step count is sized from set-up's
last step so that the call lasts about ``--seconds``. Shards, payload and
checkpoints live in the run's temporary directory.

What is compared is read from the program's state as it steps, in both
calls (:class:`Observed`): set-up's losses and the optimizer's first
moments after the first step; the window's losses of its first
``window_checked_steps`` steps (kept on the device, read once the window
has closed) and the weights and moving statistics after them. So the
resume (weights, Adam's moments and count, the generators, the shuffler's
position) is held to the reference too.

Once the window has closed the reference takes ``checked_steps +
window_checked_steps`` steps from the same payload and shards and the same
seed, and the run compares set-up's losses, the first gradient as the
optimizer got it (its first moment over ``1 - beta1``: the averaged
gradient after the clip), and the change of every parameter and moving
statistic over all those steps, the last of them the window's; each by the
worst leaf, the gap of the two norms over the reference's norm or the
median leaf's, whichever is larger (:func:`readings` says why the window's
losses are read but not compared). Leaves whose reference gradient lies
under a thousandth of the median leaf's are left out of the gradient and
change comparisons: under Adam they move by rounding alone.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import common
import frames
import weights
from reference import train as ref_train


def job(cfg: dict, tr: dict) -> dict:
    """The hyperparameters the reference takes, as the configuration and
    the traffic state them."""
    per_epoch = cfg["train_frames_per_epoch"] / (tr["batch_size"]
                                                 * tr["sub_batch"])
    return dict(tr["optimizer"], batch_size=tr["batch_size"],
                sub_batch=tr["sub_batch"],
                decay_steps=int(per_epoch
                                * tr["optimizer"]["epochs_per_decay"]),
                dropout_rate=cfg["dropout_rate"],
                renorm_t_delta=cfg["renorm_t_delta"],
                fixed_bg_threshold=cfg.get("fixed_bg_threshold"))


def build(cfg: dict, tr: dict, seed: int, device, root: str):
    """Shards, the init payload and the dataset spec under ``root``;
    returns ``(spec, shards, params0, stats0, payload path)``."""
    from densereg_torch.convert import save_converted
    from densereg_torch.data.base import DatasetSpec, ShardWriter

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n, per = tr["pool_frames"], tr["shard_frames"]
    depth, poses, _ = frames.render(n, cfg["camera"], cfg["num_joint"], gen,
                                    device)
    shards, paths = [], []
    for s in range(0, n, per):
        path = os.path.join(root, "shards", f"training-{s // per}.npz")
        with ShardWriter(path) as w:
            for i in range(s, min(s + per, n)):
                w.add(depth[i], poses[i], f"training/frame_{i:05d}.png")
        shards.append((depth[s:s + per], poses[s:s + per]))
        paths.append(path)
    spec = DatasetSpec(name=cfg["dataset"], subset="training",
                       cfg=common.camera(cfg), jnt_num=cfg["num_joint"],
                       max_depth=float(cfg.get("fixed_bg_threshold") or 0),
                       directory=root, filenames=paths, exact_num=n,
                       approximate_num=cfg["train_frames_per_epoch"],
                       fixed_bg_threshold=cfg.get("fixed_bg_threshold"))
    params0, stats0 = weights.training_weights(cfg, gen, device)
    payload = os.path.join(root, "init.msgpack")
    save_converted(dict(weights.flax_tree(params0, stats0), renorm_t=0.0),
                   payload)
    return spec, shards, params0, stats0, payload


def _train_config(cfg, tr, seed, root, **kw):
    from densereg_torch.config import TrainConfig

    opt = tr["optimizer"]
    return TrainConfig(batch_size=tr["batch_size"], sub_batch=tr["sub_batch"],
                       init_lr=opt["init_lr"],
                       lr_decay_factor=opt["lr_decay_factor"],
                       epochs_per_decay=opt["epochs_per_decay"],
                       adam_beta1=opt["adam_beta1"],
                       grad_clip_value=opt["grad_clip_value"],
                       weight_decay=opt["weight_decay"], augment=True,
                       seed=seed, base_dir=os.path.join(root, "runs"), **kw)


class Observed:
    """The program's ``train_step`` observed, in set-up's call and in the
    window's: each step's loss up to step ``last`` (a float in set-up,
    which syncs; the tensor itself in the window, read after it), set-up's
    step times, the optimizer's first moments after step 1, and the
    weights and moving statistics after step ``last``, cloned on the
    device."""

    def __init__(self, first: int, last: int):
        self.first, self.last = first, last
        self.loss, self.t, self.seen = [], [], {}

    def __enter__(self):
        import densereg_torch.train.loop as loop

        self.loop, self.inner = loop, loop.train_step
        loop.train_step = self.step
        return self

    def __exit__(self, *exc):
        self.loop.train_step = self.inner

    def step(self, state, batch, *a, **kw):
        metrics = self.inner(state, batch, *a, **kw)
        s = state.step
        if s <= self.first:
            self.loss.append(float(metrics["loss"]))
            self.t.append(time.perf_counter())
        elif s <= self.last:
            self.loss.append(metrics["loss"].detach())
        if s == 1:
            b1 = state.optimizer.param_groups[0]["betas"][0]
            self.seen["clipped1"] = {
                k: state.optimizer.state[p].get("mu", torch.zeros_like(p))
                .detach() / (1.0 - b1)
                for k, p in state.net.named_parameters()}
        if s == self.last:
            self.seen["params"] = {k: p.detach().clone() for k, p in
                                   state.net.named_parameters()}
            self.seen["stats"] = {k: t.detach().clone() for k, t in
                                  state.net.named_buffers()
                                  if k.endswith((".mean", ".var"))}
        return metrics

    def step_time(self) -> float:
        """Set-up's last step alone: the earlier ones include step 0's
        checkpoint and histograms."""
        return float(np.diff(self.t)[-1])

    def result(self) -> dict:
        """What the comparison reads, with the parameter tree's names."""
        flax = lambda d: {k.replace(".", "/"): v for k, v in d.items()}
        return dict(loss=[float(v) for v in self.loss],
                    **{k: flax(v) for k, v in self.seen.items()})


def program_steps(cfg, tr, seed, device, root, spec, payload, cell=None):
    """Set-up's call of the first ``checked_steps`` steps, then the
    resumed call: ``window_checked_steps`` steps, or with ``cell`` the
    timed window, sized to ``cell.seconds``. Returns ``(observed, steps of
    the window, its seconds, the trace directory or None)``."""
    from densereg_torch.train.loop import train

    first, k = tr["checked_steps"], tr["window_checked_steps"]
    log = lambda *a: None
    net_cfg = common.net_config(cfg)
    with Observed(first, first + k) as obs:
        train(spec, net_cfg, _train_config(cfg, tr, seed, root),
              max_steps=first, debug_level=0, init_params=payload,
              log_fn=log, device=device)
        n, kw = k, {}
        if cell is not None:
            n = max(int(round(cell.seconds / obs.step_time())), k)
            if cell.trace:
                skip, count = tr["trace_skip_steps"], tr["trace_steps"]
                n = max(n, skip + count + 1)
                kw = dict(profile_dir=os.path.join(root, "trace"),
                          profile_start=first + skip, profile_steps=count)
        tcfg = _train_config(cfg, tr, seed, root, **kw)
        if cell is not None:
            cell.warm_profiler()
            cell.window_open()
        t0 = time.perf_counter()
        train(spec, net_cfg, tcfg, restore_step="auto", max_steps=first + n,
              debug_level=0, log_fn=log, device=device)
        if cell is not None:
            cell.sync()
        elapsed = time.perf_counter() - t0
        if cell is not None:
            cell.window_close()
    return obs.result(), n, elapsed, kw.get("profile_dir")


def reference_steps(cfg, tr, seed, device, shards, params0, stats0,
                    round_operands=None, fault=None, tf32=False):
    return ref_train.train_steps(cfg, job(cfg, tr), params0, stats0, shards,
                                 common.camera_tensor(cfg, "cpu"), seed,
                                 tr["checked_steps"]
                                 + tr["window_checked_steps"], device,
                                 round_operands=round_operands, fault=fault,
                                 tf32=tf32)


def _worst_leaf(prog: dict, ref: dict, keys) -> float:
    norms = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keys}
    floor = float(np.median(list(norms.values())))
    return max(abs(float(torch.linalg.vector_norm(prog[k].float()
                                                   .to(ref[k].device)))
                   - norms[k]) / max(norms[k], floor, 1e-30) for k in keys)


def loss_gaps(prog: dict, ref: dict) -> list:
    """Each step's loss gap over the reference's loss."""
    return [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]


def readings(prog: dict, ref: dict, params0, stats0, first: int) -> dict:
    """The numbers compared: the worst loss gap of set-up's ``first``
    steps, the first gradient's worst leaf, and the worst leaf's change
    over set-up's steps and the window's checked ones. The window's losses
    are not compared: from the fourth step on, the program's and the
    reference's losses part by up to a few thousandths on sound runs,
    about as far as the control's do."""
    gaps = loss_gaps(prog, ref)
    gnorm = {k: float(torch.linalg.vector_norm(g)) for k, g in
             ref["grad1"].items()}
    median = float(np.median(list(gnorm.values())))
    moved = [k for k, v in gnorm.items() if v >= 1e-3 * median]
    grad = _worst_leaf(prog["clipped1"], ref["clipped1"], moved)
    delta = lambda after, before: {k: after[k].to(before[k].device)
                                   - before[k] for k in before}
    changes_p = dict(delta(prog["params"], params0),
                     **delta(prog["stats"], stats0))
    changes_r = dict(delta(ref["params"], params0),
                     **delta(ref["stats"], stats0))
    change = _worst_leaf(changes_p, changes_r, moved + list(stats0))
    return {"loss_gap_rel": max(gaps[:first]), "grad1_gap_rel": grad,
            "change_gap_rel": change}


def run(cell):
    cfg, tr, dev = cell.config, cell.traffic, cell.device
    root = cell.scratch
    spec, shards, params0, stats0, payload = build(cfg, tr, cell.seed, dev,
                                                   root)
    program, n, elapsed, trace_dir = program_steps(
        cfg, tr, cell.seed, dev, root, spec, payload, cell)
    counts = {}
    if trace_dir is not None:
        names = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        if names:
            cell.load_trace(os.path.join(trace_dir, names[0]))
            steps = tr["trace_steps"]
            counts = {"steps": steps,
                      "samples": steps * tr["batch_size"] * tr["sub_batch"]}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cfg, tr, cell.seed, dev, shards, params0, stats0)
    return cell.outcome(
        attempted=n, failed=0,
        end_to_end={"samples_per_s": n * tr["batch_size"] * tr["sub_batch"]
                    / elapsed},
        readings=readings(program, ref, params0, stats0,
                          tr["checked_steps"]), counts=counts)


def control_readings(cfg, tr, seed, device, side) -> dict:
    """``program``: the program's set-up steps and the resumed call's
    first steps against the reference;
    ``control``: the reference with TF32 convolutions (cuDNN's switch on a
    GPU, rounded operands on a CPU) in the program's place; and the
    reference with half of each micro-batch left out (its loss doubled)
    in the program's place."""
    import json
    import sys
    import tempfile

    from reference import net

    first = tr["checked_steps"]
    device = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="bench-ctl-") as root:
        spec, shards, params0, stats0, payload = build(cfg, tr, seed,
                                                       device, root)
        ref = reference_steps(cfg, tr, seed, device, shards, params0, stats0)
        if side == "program":
            prog = program_steps(cfg, tr, seed, device, root, spec,
                                 payload)[0]
            print(json.dumps({"seed": seed, "loss_gap_by_step":
                              loss_gaps(prog, ref)}), file=sys.stderr)
            return {"program": readings(prog, ref, params0, stats0, first)}
        out = {}
        if device.type == "cuda":
            out["control_tf32_cudnn"] = reference_steps(
                cfg, tr, seed, device, shards, params0, stats0, tf32=True)
        else:
            out["control_tf32_rounded"] = reference_steps(
                cfg, tr, seed, device, shards, params0, stats0,
                round_operands=net.tf32)
        out["fault_half_batch"] = reference_steps(
            cfg, tr, seed, device, shards, params0, stats0, fault="half")
        return {k: readings(v, ref, params0, stats0, first)
                for k, v in out.items()}
