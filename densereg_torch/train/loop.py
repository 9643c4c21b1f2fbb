"""The training loop: a host loop around the accumulating train step.

Mirrors ``densereg_tpu/train/loop.py::train``: a text log line every
``log_every`` steps (sec/batch, sec/sample), metrics every
``summary_every``, a validation batch every ``validate_every`` (K1 decodes
it on a CUDA device), a checkpoint every ``checkpoint_every`` and at the
end; the NaN guard one step late, flushed before any checkpoint; SIGTERM
checkpoints and stops; an exception leaves an emergency checkpoint;
``restore_step="auto"`` resumes the latest checkpoint, with the input
stream and the random generators where they were, so a stopped and
resumed run takes the steps an uninterrupted one would; ``init_params``
starts a fresh run from converted weights. The checkpoint namespace is
``config.model_desc``, which ``test`` (the test driver) reads too.

Observability, as the JAX loop has it: a TensorBoard event file under
``<train_dir>/summary`` (``utils.tb``) with the scalars and the learning
rate every ``summary_every`` steps, ``val/max_joint_error`` and skeleton
images at each validation (``debug_level >= 1``), parameter and gradient
histograms under the Flax key paths every ``histogram_every`` steps, and
debug images of the current batch (``debug_level >= 2``); with
``TrainConfig.profile_dir``, a ``torch.profiler`` Chrome trace of a few
steps, each a ``densereg.train.step`` span (``utils.profiling``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from densereg_torch import geometry, targets
from densereg_torch.config import EvalConfig, NetConfig, TrainConfig, model_desc
from densereg_torch.data.base import DatasetSpec
from densereg_torch.data.pipeline import InputPipeline, TestPipeline
from densereg_torch.eval.loop import (
    evaluate_multihost,
    evaluate_stream,
    make_infer_fn,
)
from densereg_torch.eval.metrics import max_joint_error
from densereg_torch.eval.visualization import SummaryImageWriter
from densereg_torch.models import DenseRegNet, from_flax, to_flax
from densereg_torch.models.bridge import flax_tree
from densereg_torch.models.layers import sync_batch_renorm
from densereg_torch.preprocess import norm_dm
from densereg_torch.train.checkpoint import CheckpointManager, restore_net
from densereg_torch.train.state import TrainState, create_train_state
from densereg_torch.train.step import train_step
from densereg_torch.utils.logging import MetricLogger, TrainLogWriter
from densereg_torch.utils.profiling import (
    StepTimer,
    span,
    start_trace,
    stop_trace,
)
from densereg_torch.utils.tb import EventWriter


def _assert_param_shapes(net: DenseRegNet, payload: dict, what: str) -> None:
    """Fail fast, naming the offending paths, when the ``params`` tree of a
    converted payload does not match ``net``'s parameters (Flax layout,
    kernels HWIO); the usual cause is a num_stack/num_fea/num_joint
    mismatch with the source model."""
    tm = {}
    for key, p in net.named_parameters():
        shape = tuple(p.shape)
        if key.endswith(".kernel"):
            shape = (shape[2], shape[3], shape[1], shape[0])
        tm[key.replace(".", "/")] = shape

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", tuple(np.shape(v))

    pm = dict(walk(payload, ""))
    if tm.keys() != pm.keys():
        missing = sorted(tm.keys() - pm.keys())
        extra = sorted(pm.keys() - tm.keys())
        raise ValueError(
            f"{what}: parameter tree mismatch — missing {missing[:3]}, "
            f"unexpected {extra[:3]} (check num_stack/num_fea/num_joint "
            f"against the converted model)")
    bad = [(k, pm[k], tm[k]) for k in tm if tm[k] != pm[k]]
    if bad:
        k, got, want = bad[0]
        raise ValueError(f"{what}: shape mismatch at {k}: {got} vs {want} "
                         f"(+{len(bad) - 1} more)")


def _load_converted_into(net: DenseRegNet, payload: dict, what: str) -> None:
    """Copy a converted payload's parameters, and its batch statistics
    where it has them, into the float, unfolded ``net`` in place."""
    _assert_param_shapes(net, payload["params"], what)
    stats = (payload["batch_stats"] if "batch_stats" in payload
             else to_flax(net)["batch_stats"])
    loaded = from_flax({"params": payload["params"], "batch_stats": stats},
                       net.cfg)
    net.load_state_dict(loaded.state_dict())


def train(spec: DatasetSpec, net_cfg: NetConfig, tcfg: TrainConfig,
          val_spec: Optional[DatasetSpec] = None, restore_step=None,
          max_steps: Optional[int] = None, net_name: str = "um_v1",
          debug_level: int = 1, init_params: Optional[str] = None,
          log_fn=print, mesh=None, device="cuda") -> TrainState:
    """Train on ``spec`` on ``device``; returns the final state.

    ``restore_step``: a step to resume from, ``"auto"`` for the latest
    checkpoint when there is one, or None (or 0) for a fresh run. On CUDA a
    float32 run turns TF32 off for the process, as serving does.

    ``init_params`` warm-starts a fresh run (step 0, fresh optimizer) from
    a converted payload (``densereg_torch.convert``): its parameters, its
    batch statistics and its renorm clock; the EMA, when
    ``tcfg.ema_decay`` is set, starts from those parameters. A checkpoint
    restore takes precedence.

    ``debug_level``: 0 draws no images, 1 (the default, as in the JAX
    package) saves skeleton PNGs of each validation batch (matplotlib),
    2 also writes debug images of the training batch into the event file
    every ``summary_every`` steps.

    ``mesh`` (``parallel.make_mesh``, one device a process) trains data
    parallel: every process of its group runs this same loop on its card
    and its share of each batch (``InputPipeline``'s multi-process form),
    the renorm moments are the global batch's and the gradients are
    summed over the ranks before the clip (``train_step``'s ``group``), so
    every rank holds the same state after each step. The files (the
    checkpoints, ``metrics.jsonl``, the event file, validation and
    ``keep_best``) are rank 0's alone; the other ranks keep their own text
    log, ``training_log.p<rank>.txt``. SIGTERM must reach every process,
    as in the JAX package: a rank that stops alone leaves the others
    waiting in the next all-reduce.
    """
    if val_spec is not None and val_spec.jnt_num != spec.jnt_num:
        raise ValueError("validation dataset must share the joint count")
    group, rank = None, 0
    if mesh is not None:
        if len(mesh.devices) != 1:
            raise NotImplementedError(
                "train(mesh=...): one device a process (start one process "
                f"per card), got {len(mesh.devices)} local devices")
        device, group, rank = mesh.devices[0], mesh.group, mesh.rank
    lead = rank == 0
    device = torch.device(device)
    steps_per_epoch = spec.approximate_num / (tcfg.batch_size * tcfg.sub_batch)
    if max_steps is None:
        max_steps = int(tcfg.epochs * steps_per_epoch)
    if device.type == "cuda" and net_cfg.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    name = model_desc(spec.name, spec.subset, net_cfg, tcfg.augment, net_name)
    train_dir = os.path.join(tcfg.base_dir, name)
    os.makedirs(train_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(train_dir, "ckpt"),
                             max_to_keep=tcfg.keep_checkpoints)

    state = create_train_state(net_cfg, tcfg, steps_per_epoch, device=device)
    if group is not None:
        sync_batch_renorm(state.net, group)
    generator = torch.Generator(device=device)
    generator.manual_seed(tcfg.seed + 104729 * rank)
    generators = {"train": generator}
    if restore_step == "auto":
        restore_step = ckpt.latest_step()
        if restore_step is not None:
            log_fn(f"[train] auto-resume from step {restore_step}")
    if restore_step is not None and restore_step != 0:
        ckpt.restore(state, restore_step, generators)
        log_fn(f"[train] restored step {state.step} from {train_dir}")
    elif init_params is not None:
        from densereg_torch.convert import load_converted

        payload = load_converted(init_params)
        _load_converted_into(state.net, payload, init_params)
        state.renorm_t = torch.tensor(
            float(payload.get("renorm_t", state.renorm_t)), dtype=torch.float32)
        if state.ema is not None:
            state.ema = {k: p.detach().clone()
                         for k, p in state.net.named_parameters()}
        log_fn(f"[train] warm-started params from {init_params} "
               f"(fresh optimizer, step 0)")

    log = TrainLogWriter(train_dir, "training_log.txt" if lead
                         else f"training_log.p{rank}.txt")
    metrics_log = MetricLogger(os.path.join(train_dir, "metrics.jsonl")
                               if lead else os.devnull)
    summary_dir = os.path.join(train_dir, "summary")
    events = EventWriter(summary_dir) if lead else None
    pipeline = InputPipeline(spec, tcfg.batch_size, tcfg.sub_batch,
                             net_cfg.input_hw, seed=tcfg.seed,
                             num_workers=tcfg.num_workers, skip=state.step,
                             host_preprocess=tcfg.host_preprocess,
                             wire_dtype=tcfg.wire_dtype, mesh=mesh,
                             device=device)
    infer_fn = val_iter = best_tracker = image_writer = None
    if val_spec is not None and lead:
        infer_fn = make_infer_fn(net_cfg, EvalConfig(), device=device)
        val_iter = rotating_batches(TestPipeline(val_spec, 3,
                                                 net_cfg.input_hw,
                                                 device=device))
        if debug_level >= 1:
            image_writer = SummaryImageWriter(summary_dir, debug_level,
                                              events)
        if tcfg.keep_best:
            best_tracker = BestTracker(
                val_spec, net_cfg.input_hw,
                os.path.join(train_dir, "ckpt_best"),
                os.path.join(train_dir, "best.json"),
                n_frames=tcfg.best_score_frames, device=device)
    elif tcfg.keep_best and lead:
        log_fn("[train] keep_best ignored: no validation split to rank by")
    debug_fn = (_make_debug_fn(net_cfg) if debug_level >= 2 and lead
                else None)

    schedule = state.optimizer.schedule
    log_fn(f"[train] lr decays per "
           f"{int(steps_per_epoch * tcfg.epochs_per_decay)} steps "
           f"x{tcfg.lr_decay_factor}; init lr {tcfg.init_lr}; {max_steps} "
           f"total steps")
    samples_per_step = tcfg.batch_size * tcfg.sub_batch
    timer = StepTimer(device=device)
    data_iter = iter(pipeline)

    # SIGTERM asks for a checkpoint at the next step boundary, then a clean
    # stop that restore_step="auto" resumes from
    preempted = {"flag": False}
    old_handler = None
    if threading.current_thread() is threading.main_thread():
        old_handler = signal.signal(
            signal.SIGTERM, lambda *_: preempted.__setitem__("flag", True))

    # Deferred NaN guard: step k's loss is copied to the host behind its
    # step and checked after step k+1 is issued; it is flushed before any
    # checkpoint, so a diverged state is never saved.
    pending = None
    prof = None

    def _guard(step_no, value):
        if not np.isfinite(value):
            raise FloatingPointError(
                f"Model diverged with loss = {value} at step {step_no}")

    def _defer(step_no, loss):
        if device.type != "cuda":
            return step_no, loss, None
        host = torch.empty((), dtype=torch.float32, pin_memory=True)
        host.copy_(loss, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return step_no, host, event

    def _flush_guard():
        nonlocal pending
        if pending is not None:
            step_no, value, event = pending
            pending = None
            if event is not None:
                event.synchronize()
            _guard(step_no, float(value))

    try:
        for step in range(state.step, max_steps):
            if tcfg.profile_dir and step == tcfg.profile_start:
                prof = start_trace(device)
            if (prof is not None
                    and step == tcfg.profile_start + tcfg.profile_steps):
                stop_trace(prof, _trace_path(tcfg), device)
                prof = None
            # opened after the trace's start and stop, so that the step
            # spans never widen the traced window
            with span("densereg.train.step"):
                sync = (step % tcfg.log_every == 0
                        or step % tcfg.summary_every == 0
                        or step % tcfg.checkpoint_every == 0
                        or step + 1 == max_steps)
                with timer:     # the feed included: it runs on the same stream
                    batch = next(data_iter)
                    histograms = (lead and tcfg.histogram_every > 0
                                  and step % tcfg.histogram_every == 0)
                    metrics = train_step(state, batch, net_cfg, tcfg,
                                         generator, with_grads=histograms,
                                         group=group)
                    grads = metrics.pop("grads", None)
                    _flush_guard()
                    if sync:
                        loss = float(metrics["loss"])
                        _guard(step, loss)
                    else:
                        loss = None
                        pending = _defer(step, metrics["loss"])

                if step % tcfg.log_every == 0:
                    log.log_step(step, max_steps, loss, timer.last,
                                 timer.last / samples_per_step)
                if step % tcfg.summary_every == 0:
                    lr = schedule(step)
                    scalars = {k: float(metrics[k])
                               for k in sorted(metrics)}
                    metrics_log.log(step, learning_rate=lr,
                                    sec_per_batch=timer.last, **scalars)
                    if events is not None:
                        events.add_scalars(dict(scalars, learning_rate=lr),
                                           step)
                    if debug_fn is not None:
                        _train_debug_images(debug_fn, state, batch, events,
                                            step)
                if histograms:
                    _write_histograms(events, state.net, grads, step)
                if val_iter is not None and step % tcfg.validate_every == 0:
                    _validate(infer_fn, state, next(val_iter), log, step,
                              log_fn, image_writer, spec.name, events)
                    if best_tracker is not None:
                        best_tracker.maybe_update(infer_fn, state, log_fn,
                                                  pre_save=_flush_guard,
                                                  generators=generators)
                if (step % tcfg.checkpoint_every == 0
                        or step + 1 == max_steps or preempted["flag"]):
                    _flush_guard()
                    if lead:
                        ckpt.save(state, generators=generators)
                if preempted["flag"]:
                    log.write(f"[train] SIGTERM: checkpointed step "
                              f"{state.step} and stopping")
                    log_fn(f"[train] preempted at step {step}; resume with "
                           f"restore_step='auto'")
                    break
        _flush_guard()
        return state
    except (KeyboardInterrupt, FloatingPointError):
        raise
    except Exception:
        # keep the live state, so that an auto-resume loses at most a step
        if lead:
            try:
                ckpt.save(state, generators=generators)
                log.write(f"[train] emergency checkpoint at step "
                          f"{state.step}")
            except Exception as exc:
                log_fn(f"[train] emergency checkpoint failed: {exc!r}")
        raise
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        if prof is not None:
            stop_trace(prof, _trace_path(tcfg), device)
        pipeline.close()
        log.close()
        metrics_log.close()
        if events is not None:
            events.close()


def test(spec: DatasetSpec, net_cfg: NetConfig, tcfg: TrainConfig,
         ecfg: EvalConfig = EvalConfig(), selected_step: Optional[int] = -1,
         net_name: str = "um_v1", train_spec: Optional[DatasetSpec] = None,
         use_ema: bool = False, use_best: bool = False,
         init_params: Optional[str] = None, log_fn=print, mesh=None,
         device="cuda") -> dict:
    """The test driver (reference model/test_model.py): restore weights,
    stream ``spec``'s frames in batches of ``ecfg.batch_size`` through the
    net in eval form and the decode on ``device``, and write
    ``{subset}-{stamp}-result.txt`` (one line a frame, exactly
    ``spec.exact_num``) and ``{subset}-{stamp}-result_error.txt`` (the
    error curve) into the run's directory, ``tcfg.base_dir`` /
    ``model_desc`` of ``train_spec`` (by default ``spec``'s dataset, subset
    ``training``). Returns ``evaluate_stream``'s report.

    The weights: checkpoint ``selected_step`` of that run (-1: the latest),
    from ``ckpt_best`` with ``use_best``, its EMA weights with ``use_ema``;
    or, with ``init_params``, a converted payload
    (``densereg_torch.convert``), which cannot combine with ``use_ema`` or
    ``use_best``.

    With a ``mesh`` (``parallel.make_mesh``) of more than one process the
    evaluation is ``eval.loop.evaluate_multihost``'s: each process decodes
    its own shards on ``mesh.devices[0]`` and rank 0 merges the parts into
    ``{subset}-step{step}-result.txt`` and ``-result_error.txt``, a name
    every process derives from the restored checkpoint's step (0 for a
    converted payload), not from its clock. A mesh of one process runs on
    its first device as without one.
    """
    if mesh is not None:
        device = mesh.devices[0]
    device = torch.device(device)
    name_spec = train_spec if train_spec is not None else spec
    name = model_desc(name_spec.name,
                      "training" if train_spec is None else train_spec.subset,
                      net_cfg, tcfg.augment, net_name)
    train_dir = os.path.join(tcfg.base_dir, name)
    if init_params is not None:
        if use_ema or use_best:
            raise ValueError("init_params is the weights source; it cannot "
                             "combine with use_ema/use_best")
        from densereg_torch.convert import load_converted

        net = DenseRegNet(dataclasses.replace(net_cfg, fold_bn=False,
                                              quantize=False))
        _load_converted_into(net, load_converted(init_params), init_params)
        step = 0
        os.makedirs(train_dir, exist_ok=True)
        log_fn(f"[test] evaluating converted weights from {init_params}")
    else:
        net = restore_net(train_dir, net_cfg, selected_step, use_ema,
                          use_best)
        log_fn(f"[test] restored from {train_dir}"
               + (" (EMA weights)" if use_ema else ""))
        if selected_step is None or selected_step == -1:
            step = CheckpointManager(os.path.join(
                train_dir, "ckpt_best" if use_best else "ckpt")).latest_step()
        else:
            step = int(selected_step)
    net = net.to(device).eval()
    if device.type == "cuda" and net_cfg.compute_dtype == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    infer_fn = make_infer_fn(net_cfg, ecfg, device=device)
    if mesh is not None and mesh.world_size > 1:
        base = os.path.join(train_dir, f"{spec.subset}-step{step}")
        report = evaluate_multihost(
            infer_fn, net, spec, ecfg.batch_size, net_cfg.input_hw,
            f"{base}-result.txt", f"{base}-result_error.txt", log_fn=log_fn,
            host_preprocess=ecfg.host_preprocess, wire_dtype=ecfg.wire_dtype,
            mesh=mesh)
        log_fn(f"[test] {report['num_frames']} frames @ "
               f"{report['fps']:.1f} fps; {report['percentages']}")
        return report
    pipe = TestPipeline(spec, ecfg.batch_size, net_cfg.input_hw,
                        host_preprocess=ecfg.host_preprocess,
                        wire_dtype=ecfg.wire_dtype, device=device)
    stamp = str(datetime.now()).replace(" ", "_")
    res_path = os.path.join(train_dir, f"{spec.subset}-{stamp}-result.txt")
    err_path = os.path.join(train_dir,
                            f"{spec.subset}-{stamp}-result_error.txt")
    report = evaluate_stream(infer_fn, net, iter(pipe), spec.exact_num,
                             res_path, err_path, log_fn=log_fn)
    log_fn(f"[test] {report['num_frames']} frames @ {report['fps']:.1f} fps; "
           f"{report['percentages']}")
    return report


class BestTracker:
    """The best-validation checkpoint (``TrainConfig.keep_best``).

    Ranks on a fixed scoring set: the first ``n_frames`` validation frames
    (fewer where the split has fewer), in batches of ``batch_size``, by the
    mean of their max-joint errors. The best state is saved to
    ``ckpt_dir`` (one kept), and ``best.json`` is written only once that
    save has committed, so the marker never names a checkpoint that is not
    on disk. The marker survives a resume."""

    def __init__(self, val_spec: DatasetSpec, input_hw, ckpt_dir: str,
                 marker_path: str, n_frames: int = 64, batch_size: int = 16,
                 device="cuda"):
        self.ckpt = CheckpointManager(ckpt_dir, max_to_keep=1)
        self.marker_path = marker_path
        self.n_frames = n_frames
        self.batch_size = batch_size
        self._pipe = TestPipeline(val_spec, batch_size, input_hw,
                                  device=device)
        self._exact = val_spec.exact_num
        self._batches = None
        self.best = {"err": float("inf"), "step": -1}
        if os.path.exists(marker_path):
            with open(marker_path) as f:
                self.best = json.load(f)

    def scoring_batches(self):
        """``{dm, pose, cfg, com, valid}`` batches on the device; ``valid``
        counts the real frames of a batch (not padding, not past
        ``n_frames``)."""
        if self._batches is None:
            left = min(self.n_frames, self._exact)
            self._batches = []
            for b in self._pipe:
                b = {k: v for k, v in b.items() if k != "name"}
                b["valid"] = min(self.batch_size, left)
                self._batches.append(b)
                left -= b["valid"]
                if left <= 0:
                    break
        return self._batches

    def score(self, infer_fn, net) -> float:
        """Mean max-joint error (mm) over the scoring set."""
        errs = []
        for b in self.scoring_batches():
            xyz = infer_fn(net, b["dm"], b["cfg"], b["com"])
            errs.append(max_joint_error(xyz, b["pose"])[:b["valid"]])
        return float(torch.cat(errs).mean())

    def maybe_update(self, infer_fn, state: TrainState, log_fn=print,
                     pre_save=lambda: None, generators=None) -> float:
        net = state.net
        was_training = net.training
        net.eval()
        try:
            err = self.score(infer_fn, net)
        finally:
            net.train(was_training)
        if err < self.best["err"]:
            pre_save()
            self.ckpt.save(state, generators=generators)
            self.best = {"err": err, "step": state.step,
                         "frames": int(sum(b["valid"]
                                           for b in self.scoring_batches()))}
            tmp = self.marker_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(self.best, f)
            os.replace(tmp, self.marker_path)
            log_fn(f"[train] new best validation error {err:.3f} mm over "
                   f"{self.best['frames']} frames at step {self.best['step']}")
        return err


def rotating_batches(pipeline):
    """An endless stream cycling through a restartable pipeline; raises if
    a whole pass yields nothing (an empty validation split)."""
    while True:
        empty = True
        for batch in pipeline:
            empty = False
            yield batch
        if empty:
            raise RuntimeError("validation pipeline yielded no batches: "
                               "empty or misconfigured split")


def _validate(infer_fn, state: TrainState, batch, log: TrainLogWriter,
              step: int, log_fn=print, image_writer=None,
              dataset_name: str = "icvl", events=None) -> float:
    """One validation batch through the live net in eval form (the moving
    statistics stay as they are): the per-joint error matrix to the
    training log, the mean to ``events`` as ``val/max_joint_error``, and
    the predicted skeletons over the crops through ``image_writer``.
    Returns the mean max-joint error, mm."""
    net = state.net
    was_training = net.training
    net.eval()
    try:
        xyz = infer_fn(net, batch["dm"], batch["cfg"], batch["com"])
    finally:
        net.train(was_training)
    gt = batch["pose"]
    errs = max_joint_error(xyz, gt).tolist()
    diff = (xyz - gt).reshape(xyz.shape[0], -1, 3).cpu().numpy()
    dist = np.linalg.norm(diff, axis=-1)
    log.write(f"[validation] step {step}")
    for i in range(diff.shape[0]):
        log.write(np.array_str(np.concatenate([diff[i], dist[i][:, None]],
                                              axis=1)))
    log.write(f"validation error: {errs}")
    log_fn(f"[validate] step {step} maxJntError {errs}")
    mean_err = float(np.mean(errs))
    if events is not None:
        events.add_scalar("val/max_joint_error", mean_err, step)
    if image_writer is not None:
        uvd = geometry.xyz2uvd(xyz, batch["cfg"]).reshape(xyz.shape[0], -1, 3)
        image_writer.save_batch_skeletons(
            "val_pts", batch["dm"].cpu().numpy(), uvd.cpu().numpy(),
            dataset_name, step)
    return mean_err


def _tree_tags(tree, prefix: str = ""):
    """``(tag, leaf)`` pairs of a nested dict, the key path joined by
    ``/``, keys sorted at each level: the order and the names of the JAX
    package's ``jax.tree_util`` walk over the same Flax tree."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(_tree_tags(val, f"{prefix}{key}/"))
        else:
            out.append((prefix + key, val))
    return out


def _write_histograms(events, net: DenseRegNet, grads, step: int) -> None:
    """Histograms of every parameter and of its averaged gradient (before
    the clip), tagged ``params/<Flax path>`` and ``grads/<Flax path>`` in
    the JAX package's order (the reference logs them every summary step,
    its ``model/train_single_gpu.py``)."""
    for tag, leaf in _tree_tags(to_flax(net)["params"]):
        events.add_histogram("params/" + tag, leaf, step)
    if grads is not None:
        for tag, leaf in _tree_tags(flax_tree(grads)):
            events.add_histogram("grads/" + tag, leaf, step)
    events.flush()


def _make_debug_fn(net_cfg: NetConfig):
    """The debug images' inputs for a few frames of the training batch: the
    normalized depth, the targets and the heads of an eval-form forward of
    the current weights (the moving statistics, which it does not move), on
    the net's device (the reference's debug-level image summaries of its
    training graph)."""
    out_h, out_w = net_cfg.output_hw

    @torch.no_grad()
    def debug(net: DenseRegNet, dms, poses, cfgs, coms):
        normed = norm_dm(dms, coms)
        gt = targets.synthesize(poses, cfgs, coms, normed, out_h, out_w)
        was_training = net.training
        net.eval()
        try:
            outs = net(normed)
        finally:
            net.train(was_training)
        est = {k: outs[k][-1] for k in ("hm", "hm3", "um")}
        return normed, gt, est

    return debug


def _train_debug_images(debug_fn, state: TrainState, batch, events, step: int,
                        n: int = 1) -> None:
    """The input depth, the targets and estimates of ``hm`` and ``hm3``
    (max over joints) and the xy angle of the unit offsets of the first
    ``n`` frames of the first micro-batch, as image records of the event
    file (``debug_level >= 2``)."""
    take = lambda t: t[0][:n]
    normed, gt, est = debug_fn(state.net, take(batch["dm"]),
                               take(batch["pose"]), take(batch["cfg"]),
                               take(batch["com"]))
    host = lambda t: t.float().cpu().numpy()
    gt_ang = host(targets.um_xy_angle(gt["um"]))
    est_ang = host(targets.um_xy_angle(est["um"]))
    normed = host(normed)
    for i in range(normed.shape[0]):
        pre = f"train/{i}/"
        events.add_image(pre + "dm", (normed[i, ..., 0] + 1.0) / 2.0, step)
        for tag, maps in (("hm_gt", gt["hm2"]), ("hm_est", est["hm"]),
                          ("hm3_gt", gt["hm3"]), ("hm3_est", est["hm3"])):
            events.add_image(pre + tag, host(maps[i]).max(axis=-1), step)
        for tag, maps in (("um_xy_gt", gt_ang), ("um_xy_est", est_ang)):
            events.add_image(pre + tag, (maps[i, ..., 0] + 1.0) / 2.0, step)
    events.flush()


def _trace_path(tcfg: TrainConfig) -> str:
    """Where ``tcfg.profile_dir``'s trace of its steps is written."""
    return os.path.join(
        tcfg.profile_dir,
        f"train_steps_{tcfg.profile_start}-"
        f"{tcfg.profile_start + tcfg.profile_steps}.pt.trace.json")
