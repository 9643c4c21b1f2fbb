"""Configuration of the PyTorch port: camera intrinsics, network, training
and decode.

Plain dataclasses mirroring ``densereg_tpu/config.py``; the constants are
the reference preprocessing's (``config.py:39-48`` of the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

D_RANGE = 300.0          # depth-normalization window size (mm)
POSE_NORM_RATIO = 100.0  # xyz pose normalization divisor (mm -> units)
PCA_NORM_RATIO = 5.0     # optional PCA-space normalization (unused hook)
MAX_DIST_2D = 4.0        # heatmap cone radius (pixels)
MAX_DIST_3D = 0.8        # offset cone radius (normalized units = 80 mm)
MAXIMUM_DEPTH = 600.0    # the reference's depth ceiling (mm)
# the network variants (densereg_tpu/config.py:64-70)
NET_MODULES = ("um_v1", "um_v1_lite", "um_v1_deconv")


class CameraConfig(NamedTuple):
    """Pinhole intrinsics ``(fx, fy, cx, cy, w, h)``; per-sample (post-crop)
    intrinsics travel as a ``(b, 6)`` float tensor."""

    fx: float
    fy: float
    cx: float
    cy: float
    w: float
    h: float

    def as_array(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.tensor(tuple(self), dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Architecture of the stacked-hourglass detector. ``net_module`` is
    ``"um_v1"`` (the reference topology), ``"um_v1_lite"`` (depthwise
    middle convolutions in the residual bottlenecks) or ``"um_v1_deconv"``
    (a learned stride-2 transposed convolution upsamples in the hourglass),
    as in ``densereg_tpu/config.py``."""

    num_stack: int = 2
    num_fea: int = 128
    kernel_size: int = 3
    num_joint: int = 16
    input_hw: Tuple[int, int] = (128, 128)
    net_module: str = "um_v1"
    # "float32" or "bfloat16": the dtype of the convolutions; heads are
    # always emitted in float32
    compute_dtype: str = "float32"
    # build bias-convs instead of conv + batch renorm (weights from
    # models.fold.fold_batch_norm)
    fold_bn: bool = False
    bn_epsilon: float = 1e-3
    # int8 convolutions on a folded net (weights from
    # models.quantize.quantize_weights): per-channel weights, per-tensor
    # activations, channels-last, every convolution on the int8 GEMM kernel
    quantize: bool = False
    # training form: dropout after the ReLUs of um_fc1 and um_fc2, and the
    # batch-renorm moving-statistics decay and schedule-clock step
    dropout_rate: float = 0.5
    bn_decay: float = 0.99
    renorm_t_delta: float = 1e-5
    # recompute the training forward on the backward pass
    # (torch.utils.checkpoint around the whole net, train.state.loss_fn);
    # the recompute replays the first pass's renorm statistics and dropout
    # masks and moves nothing
    remat: bool = False

    def __post_init__(self):
        if self.net_module not in NET_MODULES:
            raise ValueError(f"net_module must be one of {NET_MODULES}, got "
                             f"{self.net_module!r}")

    @property
    def output_hw(self) -> Tuple[int, int]:
        return (self.input_hw[0] // 4, self.input_hw[1] // 4)

    @property
    def hourglass_depth(self) -> int:
        # the bottom of the hourglass is a 2x2 map
        depth = {32: 2, 64: 3, 128: 4, 256: 5, 512: 6}.get(self.input_hw[0])
        if depth is None:
            raise ValueError(f"unsupported input size {self.input_hw}")
        return depth

    @property
    def torch_dtype(self) -> torch.dtype:
        dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
        if self.compute_dtype not in dtypes:
            raise ValueError(
                f"compute_dtype must be one of {sorted(dtypes)}, "
                f"got {self.compute_dtype!r}")
        return dtypes[self.compute_dtype]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization schedule and loop cadences: the fields of
    ``densereg_tpu/config.py::TrainConfig`` that ``train.loop.train`` uses,
    with the same defaults."""

    batch_size: int = 40
    sub_batch: int = 5            # gradient-accumulation micro steps
    epochs: int = 80
    init_lr: float = 1e-3
    lr_decay_factor: float = 0.1
    epochs_per_decay: int = 10
    adam_beta1: float = 0.5
    grad_clip_value: float = 0.2  # elementwise clip after averaging
    weight_decay: float = 5e-4    # conv-kernel L2
    loss_type: str = "l2"         # data term: "l2" (sum(x^2)/2) or "l1"
    ema_decay: Optional[float] = None   # weight EMA; None = off
    augment: bool = True
    seed: int = 0
    log_every: int = 5
    summary_every: int = 20
    validate_every: int = 40
    checkpoint_every: int = 100
    keep_checkpoints: Optional[int] = 5   # None keeps every checkpoint
    # also keep the checkpoint with the best validation error in ckpt_best/
    # (marker best.json), ranked on a fixed set of this many frames
    keep_best: bool = False
    best_score_frames: int = 64
    # parameter and gradient histograms to the event file every this many
    # steps (0: never)
    histogram_every: int = 100
    base_dir: str = "./exp/train_cache/"
    # crop on the host (the producer threads, on CPU tensors) and ship the
    # cropped float32 batch instead of raw uint16 frames; with
    # wire_dtype="uint16" the crop ships as per-batch fixed-point uint16
    # (densereg_torch.wire) and is decoded on the device
    host_preprocess: bool = False
    wire_dtype: str = "float32"
    num_workers: int = 1          # producer threads of the input pipeline
    # when set, torch.profiler traces steps [profile_start, profile_start +
    # profile_steps) into this directory as a Chrome trace
    profile_dir: Optional[str] = None
    profile_start: int = 10
    profile_steps: int = 3


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Evaluation batch size and decode settings. On a CUDA tensor the
    decode always runs the fused kernel (``ops.fused_decode``); on a CPU
    tensor its plain version."""

    batch_size: int = 40          # frames a batch of the test driver
    num_candidates: int = 5
    mean_shift_iters: int = 10
    band_width: float = 0.4
    vote_grid: int = 4            # 4x4x4 quantized voting grid
    # crop on the host and ship the crop (TrainConfig.host_preprocess), as
    # float32 or as the uint16 wire
    host_preprocess: bool = False
    wire_dtype: str = "float32"


def model_desc(dataset_name: str, subset: str, net: NetConfig, augment: bool,
               net_name: str = "um_v1") -> str:
    """Checkpoint namespace ``<dataset>_<subset>_s<stack>_f<fea>[_in<size>]
    [_daug]_<net>``, as the JAX package names it."""
    desc = f"{dataset_name}_{subset}_s{net.num_stack}_f{net.num_fea}"
    if net.input_hw[0] != 128:
        desc += f"_in{net.input_hw[0]}"
    if augment:
        desc += "_daug"
    return f"{desc}_{net_name}"
