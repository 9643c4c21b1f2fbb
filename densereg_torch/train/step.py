"""The training step: gradient accumulation over micro-batches.

Mirrors ``densereg_tpu/train/step.py::train_step_single``: the gradients
of the ``sub_batch`` micro-batches are summed (each micro loss sums over
its frames), divided by ``sub_batch``, clipped element-wise and applied
with Adam; the renorm moving statistics and the schedule clock advance
once a micro step. ``make_fused_train_step`` is the same step from raw
frames and poses, the crop included.

On a CUDA device, without a process group and without remat, each
micro-batch's forward, losses and backward replay one CUDA graph
(:class:`MicroBatchGraph`); elsewhere they run eagerly. A synchronised
renorm all-reduces inside the forward, remat rewinds the generator on the
host, and the CPU has no graphs. ``graph_counts`` counts the micro-batches
by how they ran.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from densereg_torch.config import NetConfig, TrainConfig
from densereg_torch.preprocess import preprocess_batch_from_pose
from densereg_torch.train.state import (
    TrainState,
    augment_targets,
    forward_loss,
    loss_fn,
    renorm_clip_bounds,
)
from densereg_torch.utils.profiling import span


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over a list of tensors (``optax.global_norm``)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def all_reduce_sum_(tensors, group) -> None:
    """Sum each tensor over the ranks of ``group``, in place, in one flat
    all-reduce (one bucket: the gradient of this ~2M-parameter net is a
    few MB)."""
    import torch.distributed as dist

    with span("densereg.train.all_reduce"):
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(
            flat.split([t.numel() for t in tensors]), tensors)])


# micro-batches by how their forward and backward ran: captured into a CUDA
# graph (and replayed once), replaying a captured graph, or eagerly (the
# warm-up pass before a capture included)
graph_counts = dict.fromkeys(("captures", "replays", "eager"), 0)

GT_KEYS = ("hm2", "hm3", "um")


def graphed(net_cfg: NetConfig, device: torch.device, group=None) -> bool:
    """Whether :func:`train_step` replays its micro-batches as a CUDA
    graph: on a CUDA device, without a process group (a synchronised
    renorm all-reduces inside the forward) and without ``remat`` (which
    sets the generator's state back on the host)."""
    return device.type == "cuda" and group is None and not net_cfg.remat


def _pointers(net: torch.nn.Module) -> Tuple[int, ...]:
    """Where the net's parameters, gradients and moving statistics lie:
    the memory a captured graph reads and writes."""
    return tuple(t.data_ptr() for p in net.parameters()
                 for t in (p, p.grad)) + tuple(
        b.data_ptr() for b in net.buffers())


class MicroBatchGraph:
    """A micro-batch's training forward, losses and ``backward()``
    captured once as a CUDA graph and replayed for every later micro-batch
    of the same shapes, on one net with one generator.

    The graph reads static inputs: ``normed``, the targets ``hm2``,
    ``hm3`` and ``um``, and the renorm clip bounds
    (``train.state.renorm_clip_bounds``, written from pinned memory
    without blocking); each call copies its micro-batch into them. The
    backward adds into the parameters' own ``.grad`` tensors, which must
    exist before the first call. The renorm moving statistics move in
    place, and the dropout masks come from ``generator``, registered with
    the graph, so replays and eager draws share its stream in the eager
    order.

    The first call is the warm-up: an eager pass on the graph's side
    stream. The second captures, then replays for its own micro-batch;
    later calls replay, and capture again first wherever a parameter,
    gradient or moving statistic has moved (never a replay into freed
    memory). Each call returns its micro-batch's metrics, copied out of
    the graph's static output."""

    def __init__(self, net, net_cfg: NetConfig, tcfg: TrainConfig,
                 generator: Optional[torch.Generator],
                 normed: torch.Tensor, gt: Dict[str, torch.Tensor]):
        self.net, self.net_cfg, self.tcfg = net, net_cfg, tcfg
        self.generator = generator
        self.stream = torch.cuda.Stream(normed.device)
        self.normed = torch.empty_like(normed)
        self.gt = {k: torch.empty_like(gt[k]) for k in GT_KEYS}
        self.bounds = torch.empty(4, dtype=torch.float32,
                                  device=normed.device)
        self.graph = self.out = self.pointers = self.names = None
        self.warm = False

    def _pass(self) -> torch.Tensor:
        b = self.bounds
        total, metrics = forward_loss(self.net, self.normed, self.gt,
                                      self.net_cfg, self.tcfg,
                                      (b[0], b[1]), (b[2], b[3]),
                                      self.generator)
        total.backward()
        self.names = list(metrics)
        return torch.stack(list(metrics.values()))

    def _capture(self) -> None:
        self.graph = self.out = None        # a stale graph's pool first
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, stream=self.stream):
            self.out = self._pass()
        self.graph = graph

    def __call__(self, normed: torch.Tensor, gt: Dict[str, torch.Tensor],
                 bounds: np.ndarray) -> Dict[str, torch.Tensor]:
        self.normed.copy_(normed)
        for k, v in self.gt.items():
            v.copy_(gt[k])
        self.bounds.copy_(torch.from_numpy(bounds).pin_memory(),
                          non_blocking=True)
        if not self.warm:
            main = torch.cuda.current_stream(self.normed.device)
            self.stream.wait_stream(main)
            with torch.cuda.stream(self.stream):
                out = self._pass()
            main.wait_stream(self.stream)
            out.record_stream(main)     # made on the side stream, read here
            self.warm = True
            graph_counts["eager"] += 1
        else:
            pointers = _pointers(self.net)
            if self.graph is None or pointers != self.pointers:
                self._capture()
                self.pointers = pointers
                graph_counts["captures"] += 1
            else:
                graph_counts["replays"] += 1
            with span("densereg.train.graph_replay"):
                self.graph.replay()
                out = self.out.clone()
        return dict(zip(self.names, out.unbind()))


def _micro_graph(state: TrainState, net_cfg: NetConfig, tcfg: TrainConfig,
                 generator, normed, gt) -> MicroBatchGraph:
    """The state's graph for this micro-batch's shapes and dtypes, made
    anew for another net or generator."""
    key = (tuple((tuple(t.shape), t.dtype)
                 for t in (normed, *(gt[k] for k in GT_KEYS))),
           net_cfg, tcfg.loss_type, tcfg.weight_decay)
    graph = state.graphs.get(key)
    if (graph is None or graph.net is not state.net
            or graph.generator is not generator):
        state.graphs.pop(key, None)
        graph = state.graphs[key] = MicroBatchGraph(
            state.net, net_cfg, tcfg, generator, normed, gt)
    return graph


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               net_cfg: NetConfig, tcfg: TrainConfig,
               generator: Optional[torch.Generator] = None,
               with_grads: bool = False, group=None):
    """One optimizer step, in place on ``state``.

    Its phases are spans (``utils.profiling``): each micro-batch's
    ``loss_fn`` call and backward pass ``densereg.train.forward_backward``
    (``loss_fn``'s augmentation and targets ``augment_targets`` inside
    it, and where the step is :func:`graphed` the graph's replay
    ``densereg.train.graph_replay``), the update ``densereg.train.optimizer``.
    A graphed step zeroes the gradients in place (it makes those that are
    None), where an eager one sets them to None.

    Args:
      batch: ``dm``, ``pose``, ``cfg``, ``com`` with leading ``(sub_batch,
        batch)`` axes, on the net's device.
      generator: draws augmentation and dropout (on the net's device).
      with_grads: also return the averaged gradient (before the clip) as
        ``metrics["grads"]``, keyed like the net's parameters.
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
    named = [(k, p) for k, p in net.named_parameters()]
    params = [p for _, p in named]
    use_graph = graphed(net_cfg, batch["dm"].device, group)
    if use_graph:
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch._foreach_zero_([p.grad for p in params])
    else:
        state.optimizer.zero_grad(set_to_none=True)
    per_micro = []
    t = state.renorm_t
    for i in range(sub):
        mb = {k: v[i] for k, v in batch.items()}
        with span("densereg.train.forward_backward"):
            if use_graph:
                normed, gt = augment_targets(mb, net_cfg, tcfg, generator)
                run = _micro_graph(state, net_cfg, tcfg, generator, normed,
                                   gt)
                metrics = run(normed, gt, renorm_clip_bounds(t))
            else:
                loss, metrics = loss_fn(net, mb, net_cfg, tcfg, t,
                                        generator, group)
                loss.backward()
                graph_counts["eager"] += 1
        per_micro.append(metrics)
        t = t + net_cfg.renorm_t_delta
    with torch.no_grad(), span("densereg.train.optimizer"):
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
