"""The yardstick's arithmetic: operations and bytes from a configuration's
shapes, and the H100's published peaks (NVIDIA's data sheet, SXM part,
dense rates without sparsity, at the full 700 W power limit).

Operations count 2 per multiply-add, convolutions only (elementwise work,
pooling and the decode's arithmetic are not counted), as
``torch.utils.flop_counter.FlopCounterMode`` counts them.
"""

from __future__ import annotations

from reference.net import conv_layers

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # float32: TF32 off
PEAK_BYTES_PER_S = 3.35e12                              # HBM3


def conv_flops(layer) -> int:
    _, cin, cout, k, _, out_h, out_w, _ = layer
    return 2 * out_h * out_w * cout * cin * k * k


def forward_flops(cfg: dict) -> int:
    """Operations of one frame's forward pass."""
    return sum(conv_flops(layer) for layer in conv_layers(cfg))


def train_flops(cfg: dict) -> int:
    """Operations of one sample's training step: each convolution's forward,
    its weight gradient, and its input gradient, which the first
    convolution (whose input is the data) does not need."""
    layers = conv_layers(cfg)
    return 3 * forward_flops(cfg) - conv_flops(layers[0])


def decode_bytes(b: int, j: int, out_hw: int, num_candidates: int = 5) -> int:
    """Bytes that one decode call of ``b`` frames needs, counted once from
    shapes whatever implements it: the float32 heatmaps ``hm`` and ``hm3``
    whole, the head-grid depth, the offsets ``um`` only at the candidates
    each joint keeps, the per-frame intrinsics and centers in, and the
    joints out."""
    px = out_hw * out_hw
    heads = 2 * b * px * j * 4
    depth = b * px * 4
    offsets = b * j * num_candidates * 3 * 4
    frame_in = b * (6 + 3) * 4
    joints_out = b * j * 3 * 4
    return heads + depth + offsets + frame_in + joints_out
