"""Host-to-device wire codec for cropped depth batches.

A copy of ``densereg_tpu/wire.py``, so that the port imports nothing of
the JAX package; ``decode_dm_u16`` also takes torch tensors, so the decode
runs on the device the crop was copied to. With ``host_preprocess`` the
crop is made on the host, and the cropped batch is what crosses the bus.
Its value range is narrow (raw millimetres inside the com window,
background exactly 0.0, ``preprocess.crop_from_xyz_pose``), so it can
ship as per-batch fixed-point uint16:

    scale = max(dm) / 65535          (one f32 scalar per batch)
    q     = round(dm / scale)        (uint16, zeros stay zeros)
    dm'   = q * scale                (on the device)

Half the bytes of float32, quantization error max(dm)/131070 (about
0.005 mm for a 600 mm crop) and the float32 rounding of the codec
(:func:`error_bound`). Background zeros are kept exactly
(scale-only encoding, no offset), so ``d > 0`` validity masks are
unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

WIRE_DTYPES = ("float32", "uint16")


def encode_dm_u16(dm: np.ndarray):
    """Encode a non-negative float depth batch as (uint16, f32 scale).

    Args:
      dm: (..., h, w, 1) float array, values >= 0 (cropped raw-mm depth;
        negatives, which the crop never produces, are clamped to 0).
    Returns:
      (q, scale): ``q`` uint16 with ``dm``'s shape; ``scale`` a float32
      array of shape (1,) * dm.ndim, so it broadcasts over the batch.
    """
    dm = np.asarray(dm, np.float32)
    hi = float(dm.max(initial=0.0))
    scale = np.float32(max(hi, 1e-6) / 65535.0)
    q = np.clip(np.rint(dm / scale), 0.0, 65535.0).astype(np.uint16)
    return q, np.full((1,) * dm.ndim, scale, np.float32)


def decode_dm_u16(q, scale):
    """The inverse of :func:`encode_dm_u16`: ``q`` as float32 times
    ``scale``, on numpy arrays or on torch tensors (on their device)."""
    if isinstance(q, torch.Tensor):
        return q.to(torch.float32) * scale
    return q.astype(np.float32) * scale


def error_bound(hi: float) -> float:
    """The most a decoded depth can be off the depth it encodes, for a batch
    whose largest depth is ``hi``: half a quantization step, plus the
    float32 rounding of the quotient ``dm / scale``, of ``scale`` and of the
    product ``q * scale``, each at most ``65535 * 2**-24`` of a step."""
    return hi / 65535.0 * (0.5 + 3 * 65535.0 * 2.0 ** -24)


def check_wire(host_preprocess: bool, wire_dtype: str) -> None:
    """Refuse an unknown wire dtype, and the uint16 wire without
    ``host_preprocess`` (the device-crop path already ships raw uint16
    frames)."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be one of {WIRE_DTYPES}")
    if wire_dtype != "float32" and not host_preprocess:
        raise ValueError("wire_dtype=uint16 requires host_preprocess "
                         "(the device-crop path already ships raw "
                         "uint16 frames)")
