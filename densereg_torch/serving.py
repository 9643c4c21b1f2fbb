"""Batched serving: full depth frames + bounding boxes in, xyz joints out.

Mirrors ``densereg_tpu/serving.py``::

    predictor = Predictor(variables, net_cfg, camera, max_batch=256)
    xyz = predictor(frames_mm, bbxs)        # (b, 3j) mm, camera space

Per dispatch, on the predictor's device: crop from the boxes, center of
mass, depth normalization, the stacked hourglass (batch norm folded into
the convolutions by default), the head-grid subsample and the vote decode,
the custom op ``densereg::fused_decode`` (the fused decode kernel on CUDA).
That program is one module, :class:`ServingModule`, which
``densereg_torch.export`` exports as it stands. The host side (chunks,
bucket padding, the pinned feed, the fetch, the warm-up) is
``host_loop.HostLoop``, which the exported predictor shares. The float
nets run eagerly. The int8 net's forward on a card replays one CUDA graph
for each dispatch shape (``models.int8_graph``), captured at the shape's
first dispatch (``warmup`` makes that one of set-up's); ``torch.export``
traces the eager forward.

With a ``mesh`` (``parallel.make_mesh``) a dispatch is split over the
mesh's devices. Under a process group every process, one card each,
calls the predictor with the same request, runs its rows, and the joints
are gathered (``all_gather`` over the group), so that every process
returns all of them; a mesh of one process splits its rows over its local
cards, each with its own replica of the module.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from densereg_torch.config import CameraConfig, EvalConfig, NetConfig
from densereg_torch.decode import decode_poses
from densereg_torch.host_loop import HostLoop, bucket_ladder
from densereg_torch.models import fold_batch_norm, from_flax, to_flax
from densereg_torch.models.bridge import is_folded, is_quantized
from densereg_torch.models.int8_graph import Int8ForwardGraph
from densereg_torch.models.quantize import calibrate, quantize_weights
from densereg_torch.preprocess import (
    center_of_mass,
    crop_from_bbx,
    method2_resize,
    norm_dm,
)
from densereg_torch.utils.profiling import span


class ServingModule(nn.Module):
    """The serving program of one device: raw frames ``(b, H, W, 1)``
    (float32 or uint16 mm) and boxes ``(b, 5)`` in, xyz ``(b, 3j)`` mm out.
    ``net`` is the eval-form ``DenseRegNet``, ``cam`` the sensor's
    ``(fx, fy, cx, cy, w, h)`` as a float32 tensor (a buffer, so that an
    exported program carries it)."""

    def __init__(self, net: nn.Module, cam: torch.Tensor,
                 ecfg: EvalConfig):
        super().__init__()
        self.net = net
        self.register_buffer("cam", cam)
        self.ecfg = ecfg
        self.graph = Int8ForwardGraph(net)

    def normed(self, frames: torch.Tensor, bbxs: torch.Tensor):
        """Frames and boxes -> the net's input (normalized depth crops),
        ``cfgs`` and ``coms``."""
        in_h, in_w = self.net.cfg.input_hw
        with span("densereg.preprocess"):
            dms, cfgs = crop_from_bbx(frames, bbxs, self.cam, in_h, in_w)
            coms = center_of_mass(dms, cfgs)
            return norm_dm(dms, coms), cfgs, coms

    def _net(self, normed: torch.Tensor):
        """The net's heads, through the int8 net's CUDA graph where it
        engages (:class:`Int8ForwardGraph`): a replay's heads are the
        graph's own tensors, which the next dispatch of that shape
        overwrites."""
        with span("densereg.net"):
            if not self.graph.engaged(normed.device):
                return self.net(normed)
            return self.graph(normed)

    def _subsample(self, outs, normed: torch.Tensor):
        """The last stack's ``hm, hm3, um`` (NHWC views) and the
        head-grid depth."""
        out_h, out_w = self.net.cfg.output_hw
        return (outs["hm"][-1], outs["hm3"][-1], outs["um"][-1],
                method2_resize(normed, out_h, out_w))

    def heads(self, frames: torch.Tensor, bbxs: torch.Tensor):
        """The decode's inputs: the last stack's ``hm, hm3, um`` (NHWC
        views), the head-grid depth, ``cfgs`` and ``coms``; the heads of a
        replay copied stride for stride, so that the next dispatch leaves
        them as they are."""
        normed, cfgs, coms = self.normed(frames, bbxs)
        hm, hm3, um, dm = self._subsample(self._net(normed), normed)
        if self.graph.engaged(normed.device):
            hm, hm3, um = (torch.empty_strided(
                t.shape, t.stride(), dtype=t.dtype,
                device=t.device).copy_(t) for t in (hm, hm3, um))
        return hm, hm3, um, dm, cfgs, coms

    def forward(self, frames: torch.Tensor, bbxs: torch.Tensor):
        # the decode reads the heads on the stream before the next
        # dispatch's replay rewrites them: no copy
        normed, cfgs, coms = self.normed(frames, bbxs)
        outs = self._net(normed)
        with span("densereg.decode"):
            return decode_poses(*self._subsample(outs, normed), cfgs, coms,
                                self.ecfg)["xyz"]


class Predictor(HostLoop):
    """Serve a DenseRegNet from its Flax-layout ``variables`` (nested dicts of
    arrays, as ``models.bridge.from_flax`` takes them).

    ``net_cfg.compute_dtype`` is ``"float32"`` or ``"bfloat16"``. A float32
    predictor on CUDA turns TF32 off for the whole process
    (``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` set to False): cuDNN would
    otherwise run its float32 convolutions in TF32.

    ``quantize=True`` serves the int8 net (``models.quantize``):
    per-channel int8 weights, every convolution on the int8 GEMM kernel
    (``ops.int8_gemm``) on CUDA. With ``calibration``, a ``(frames_mm,
    bbxs)`` pair of representative requests (the layout of ``__call__``),
    the activation scales are recorded once through the predictor's own
    crop and normalization and are static from then on; without it each
    batch scales its activations by its own maxima (dynamic).
    ``compute_dtype`` is then the dtype of the float views between layers.
    On CUDA the int8 forward replays a CUDA graph for each bucket
    (``models.int8_graph``), captured at the bucket's first dispatch.

    ``mesh`` (``parallel.make_mesh``) serves on all of the mesh's devices:
    the predictor then lives on ``mesh.devices`` (``device`` is not read),
    and every process of the mesh's group must make the same calls (see
    the module's docstring).
    """

    # uint16 integer-mm frames are accepted natively and cast on the device
    accepts_u16 = True

    def __init__(self, variables, net_cfg: NetConfig, camera: CameraConfig,
                 max_batch: int = 64, ecfg: EvalConfig = EvalConfig(),
                 fold_bn: bool = True, mesh=None, quantize: bool = False,
                 calibration=None, batch_buckets=None, device="cuda"):
        if mesh is not None:
            from densereg_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh must be a densereg_torch.parallel "
                                f"Mesh (make_mesh), got {type(mesh)}")
            device = mesh.devices[0]
        self.mesh = mesh
        if (fold_bn or quantize) and not is_folded(variables):
            variables = fold_batch_norm(variables, eps=net_cfg.bn_epsilon)
        if quantize and not is_quantized(variables):
            variables = quantize_weights(variables)
        net = from_flax(variables, net_cfg)
        self.net_cfg = net.cfg
        self.device = torch.device(device)
        dtype = self.net_cfg.torch_dtype
        if self.net_cfg.fold_bn and not self.net_cfg.quantize:
            # no batch statistics left to keep in float32 (the int8 net
            # keeps its scales and biases in float32, as the JAX one)
            net = net.to(dtype)
        self.net = net.to(self.device)
        if dtype == torch.float32 and self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.camera = camera
        self.frame_hw = (int(camera.h), int(camera.w))
        self.num_joint = self.net_cfg.num_joint
        self.ecfg = ecfg
        self.module = ServingModule(self.net, camera.as_array(
            device=self.device), ecfg)
        self._cam = self.module.cam
        self.max_batch = max_batch
        if quantize and calibration is not None:
            frames, bbxs = calibration
            frames = np.asarray(frames, np.float32)
            if frames.ndim == 3:
                frames = frames[..., None]
            with torch.inference_mode():
                normed = self.module.normed(
                    self._to_device(frames),
                    self._to_device(np.asarray(bbxs, np.float32)))[0]
            calibrate(self.net, [normed])
        # one replica of the program on each further local card of a mesh
        # of one process (under a group a process has one card)
        self._replicas = [self.module] + [
            copy.deepcopy(self.module).to(d)
            for d in (mesh.devices[1:] if mesh is not None else ())]
        self.batch_buckets = bucket_ladder(batch_buckets, max_batch)

    @classmethod
    def from_checkpoint(cls, train_dir: str, net_cfg: NetConfig,
                        camera: CameraConfig, step: Optional[int] = -1,
                        use_ema: bool = False, use_best: bool = False,
                        **kwargs) -> "Predictor":
        """Serve a checkpoint of the port's trainer (``train.loop.train``):
        ``train_dir`` is the run's directory, ``step`` a saved step (-1: the
        latest), ``use_ema`` the EMA weights (a run trained with
        ``TrainConfig.ema_decay``), ``use_best`` the best-validation
        checkpoint (``train_dir/ckpt_best``, ``TrainConfig.keep_best``).
        The weights go through the Flax layout (``models.to_flax``), so batch
        norm is folded as for any tree; ``kwargs`` go to ``__init__``."""
        from densereg_torch.train.checkpoint import restore_net

        net = restore_net(train_dir, net_cfg, step, use_ema, use_best)
        return cls(to_flax(net), net_cfg, camera, **kwargs)

    @classmethod
    def from_converted(cls, msgpack_path: str, net_cfg: NetConfig,
                       camera: CameraConfig, **kwargs) -> "Predictor":
        """Serve a converted reference checkpoint (``densereg_torch.convert``
        or the JAX package's, the same file format); ``kwargs`` go to
        ``__init__``, so ``quantize=True`` with ``calibration`` calibrates
        the loaded weights."""
        from densereg_torch.convert import load_converted

        payload = load_converted(msgpack_path)
        variables = {"params": payload["params"],
                     "batch_stats": payload["batch_stats"]}
        return cls(variables, net_cfg, camera, **kwargs)

    @torch.inference_mode()
    def _heads(self, frames: torch.Tensor, bbxs: torch.Tensor):
        """Device frames and boxes -> the decode's inputs: the last stack's
        ``hm, hm3, um`` (NHWC views), the head-grid depth, ``cfgs`` and
        ``coms``."""
        return self.module.heads(frames, bbxs)

    @torch.inference_mode()
    def _predict(self, frames: torch.Tensor, bbxs: torch.Tensor):
        """Device frames and boxes -> xyz on the predictor's device. With a
        mesh: this process's rows of the request, split again over its
        devices, then the gather of every process's joints."""
        if self.mesh is None:
            return self.module(frames, bbxs)
        return _predict_on_mesh(self.mesh, self._replicas, frames, bbxs)


def _predict_on_mesh(mesh, replicas, frames: torch.Tensor,
                     bbxs: torch.Tensor) -> torch.Tensor:
    """Split ``(b, ...)`` rows over the ``mesh.size`` devices of the mesh
    (padded by repeating the last row to a multiple of it), run each local
    slice on its replica, and gather the joints of every process onto
    ``mesh.devices[0]``; returns ``(b, 3j)``."""
    import torch.distributed as dist

    b = frames.shape[0]
    per = -(-b // mesh.size)
    pad = per * mesh.size - b
    if pad:
        frames = torch.cat([frames, frames[-1:].expand(pad, *frames.shape[1:])])
        bbxs = torch.cat([bbxs, bbxs[-1:].expand(pad, *bbxs.shape[1:])])
    first = mesh.rank * len(mesh.devices) * per
    outs = []
    for i, (dev, rep) in enumerate(zip(mesh.devices, replicas)):
        rows = slice(first + i * per, first + (i + 1) * per)
        outs.append(rep(frames[rows].to(dev), bbxs[rows].to(dev))
                    .to(mesh.devices[0]))
    local = torch.cat(outs)
    if mesh.group is None:
        return local[:b]
    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    return torch.cat(parts)[:b]
