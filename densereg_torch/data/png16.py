"""Depth-image codecs for the source datasets (a copy of
``densereg_tpu/data/png16.py``, which is numpy-only).

The reference decodes inside the TF graph (``tf.image.decode_png`` with
uint16 for ICVL/MSRA — reference data/icvl.py:131-143 — and the NYU
``G<<8 | B`` RGB packing — reference data/nyu.py:148-156).  Here decoding
is host-side, before the shards are written; these helpers are pure numpy
+ PIL.
"""

from __future__ import annotations

import io

import numpy as np


def png_dims(data: bytes):
    """(height, width) from the IHDR chunk, or None if not a PNG."""
    if len(data) < 24 or data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    w = int.from_bytes(data[16:20], "big")
    h = int.from_bytes(data[20:24], "big")
    return h, w


def decode_png16(data: bytes) -> np.ndarray:
    """16-bit grayscale PNG bytes -> (h, w) uint16 (ICVL / MSRA depth).

    Uses the native zlib codec (densereg_torch.data.native / native/depthio.cc)
    when built, PIL otherwise."""
    from densereg_torch.data import native

    dims = png_dims(data)
    if dims is not None and native.available():
        out = native.decode_png16(data, dims[0], dims[1], nyu_packed=False)
        if out is not None:
            return out
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    arr = np.asarray(img)
    if arr.dtype == np.int32:  # PIL mode "I"
        arr = arr.astype(np.uint16)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint16)


def decode_nyu_png(data: bytes) -> np.ndarray:
    """NYU 8-bit RGB PNG with depth packed as ``(G << 8) | B``
    (reference data/nyu.py:148-156) -> (h, w) uint16."""
    from densereg_torch.data import native

    dims = png_dims(data)
    if dims is not None and native.available():
        out = native.decode_png16(data, dims[0], dims[1], nyu_packed=True)
        if out is not None:
            return out
    from PIL import Image

    img = Image.open(io.BytesIO(data)).convert("RGB")
    arr = np.asarray(img, np.uint16)
    return (arr[..., 1] << 8) | arr[..., 2]


def read_depth_png(path: str, nyu_packed: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    return decode_nyu_png(data) if nyu_packed else decode_png16(data)


def read_msra_bin(path: str) -> np.ndarray:
    """MSRA proprietary ``.bin`` cropped depth -> full-frame (rows, cols)
    float32 (reference data/msra.py:120-137): 6 int32 header values
    (cols, rows, left, top, right, bottom) then float32 payload for the
    crop window."""
    with open(path, "rb") as f:
        header = np.fromfile(f, np.int32, 6)
        cols, rows, left, top, right, bottom = (int(x) for x in header)
        payload = np.fromfile(f, np.float32)
    crop = payload.reshape(bottom - top, right - left)
    full = np.zeros((rows, cols), np.float32)
    full[top:bottom, left:right] = crop
    return full
