"""Batched serving: full depth frames + bounding boxes in, xyz joints out.

Mirrors ``densereg_tpu/serving.py``::

    predictor = Predictor(variables, net_cfg, camera, max_batch=256)
    xyz = predictor(frames_mm, bbxs)        # (b, 3j) mm, camera space

Per dispatch, on the predictor's device: crop from the boxes, center of
mass, depth normalization, the stacked hourglass (batch norm folded into
the convolutions by default), the head-grid subsample and the vote decode,
the custom op ``densereg::fused_decode`` (the fused decode kernel on CUDA).
That program is one module, :class:`ServingModule`, which
``densereg_torch.export`` exports as it stands. Each dispatch is padded to
the smallest of ``batch_buckets`` that fits it, so the device sees a fixed
set of batch shapes. The port runs eagerly.

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
from densereg_torch.models import fold_batch_norm, from_flax, to_flax
from densereg_torch.models.bridge import is_folded, is_quantized
from densereg_torch.models.quantize import calibrate, quantize_weights
from densereg_torch.preprocess import (
    center_of_mass,
    crop_from_bbx,
    method2_resize,
    norm_dm,
)


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

    def normed(self, frames: torch.Tensor, bbxs: torch.Tensor):
        """Frames and boxes -> the net's input (normalized depth crops),
        ``cfgs`` and ``coms``."""
        in_h, in_w = self.net.cfg.input_hw
        dms, cfgs = crop_from_bbx(frames, bbxs, self.cam, in_h, in_w)
        coms = center_of_mass(dms, cfgs)
        return norm_dm(dms, coms), cfgs, coms

    def heads(self, frames: torch.Tensor, bbxs: torch.Tensor):
        """The decode's inputs: the last stack's ``hm, hm3, um`` (NHWC
        views), the head-grid depth, ``cfgs`` and ``coms``."""
        out_h, out_w = self.net.cfg.output_hw
        normed, cfgs, coms = self.normed(frames, bbxs)
        outs = self.net(normed)
        tiny = method2_resize(normed, out_h, out_w)
        return (outs["hm"][-1], outs["hm3"][-1], outs["um"][-1], tiny, cfgs,
                coms)

    def forward(self, frames: torch.Tensor, bbxs: torch.Tensor):
        return decode_poses(*self.heads(frames, bbxs), self.ecfg)["xyz"]


class Predictor:
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
            calibrate(self.net, [self._normed(
                self._to_device(frames),
                self._to_device(np.asarray(bbxs, np.float32)))[0]])
        # one replica of the program on each further local card of a mesh
        # of one process (under a group a process has one card)
        self._replicas = [self.module] + [
            copy.deepcopy(self.module).to(d)
            for d in (mesh.devices[1:] if mesh is not None else ())]
        # max_batch is always a bucket, so every chunk has a home
        if batch_buckets:
            buckets = sorted({int(v) for v in batch_buckets} | {max_batch})
            if buckets[0] < 1 or buckets[-1] > max_batch:
                raise ValueError(
                    f"batch_buckets must lie in [1, max_batch={max_batch}]; "
                    f"got {sorted(batch_buckets)}")
            self.batch_buckets = tuple(buckets)
        else:
            self.batch_buckets = (max_batch,)

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
    def _normed(self, frames: torch.Tensor, bbxs: torch.Tensor):
        """Device frames and boxes -> the net's input (normalized depth
        crops), ``cfgs`` and ``coms``."""
        return self.module.normed(frames, bbxs)

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

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def warmup(self, with_u16: bool = True) -> None:
        """Run every (bucket, dtype) path once, so that no request pays for
        the first launch or the kernel build."""
        hw = (int(self.camera.h), int(self.camera.w))
        bbx = np.asarray([[0, 0, hw[0], hw[1], 500.0]], np.float32)
        dtypes = (np.float32, np.uint16) if with_u16 else (np.float32,)
        for bucket in self.batch_buckets:
            for dt in dtypes:
                self._dispatch(np.zeros((bucket,) + hw + (1,), dt),
                               np.repeat(bbx, bucket, 0)).cpu()

    def _dispatch(self, frames: np.ndarray, bbxs: np.ndarray) -> torch.Tensor:
        """Pad one chunk to the smallest bucket that fits and enqueue it;
        returns the device result, with bucket rows, without waiting."""
        b = frames.shape[0]
        bucket = next(v for v in self.batch_buckets if v >= b)
        pad = bucket - b
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
            bbxs = np.concatenate([bbxs, np.repeat(bbxs[-1:], pad, 0)])
        return self._predict(self._to_device(frames),
                             self._to_device(np.asarray(bbxs, np.float32)))

    def __call__(self, frames_mm: np.ndarray, bbxs: np.ndarray) -> np.ndarray:
        """frames_mm: (b, H, W) or (b, H, W, 1) raw depth, mm;
        bbxs: (b, 5) = (top, left, bottom, right, depth_threshold).
        Returns (b, 3j) xyz mm.

        Requests larger than ``max_batch`` run as a double-buffered chunk
        pipeline: chunk k+1 is padded and enqueued before chunk k's result
        is fetched."""
        frames = np.asarray(frames_mm)
        if frames.dtype != np.uint16:  # keep integer depth in native width
            frames = frames.astype(np.float32, copy=False)
        if frames.ndim == 3:
            frames = frames[..., None]
        b = frames.shape[0]
        if b == 0:
            return np.zeros((0, 3 * self.net_cfg.num_joint), np.float32)
        out, pending = [], None
        for i in range(0, b, self.max_batch):
            chunk = frames[i:i + self.max_batch]
            dev = self._dispatch(chunk, bbxs[i:i + self.max_batch])
            if pending is not None:
                out.append(pending[0][:pending[1]].cpu().numpy())
            pending = (dev, len(chunk))
        out.append(pending[0][:pending[1]].cpu().numpy())
        return out[0] if len(out) == 1 else np.concatenate(out)


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
