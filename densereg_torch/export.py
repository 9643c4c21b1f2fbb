"""Ahead-of-time export of the serving program, the port of
``densereg_tpu/export.py``.

:func:`export_predictor` bakes a :class:`densereg_torch.serving.Predictor`'s
weights and its whole serving program (crop, normalization, the hourglass,
the vote decode) into ``torch.export`` programs, one per (platform, batch
bucket, frame dtype), serialized with ``torch.export.save`` into one file;
:func:`load_exported` runs them without the model code or a checkpoint. The
kernels are ``torch.library`` custom ops (``densereg::fused_decode``, the
int8 convolutions' ``densereg::int8_*``), recorded in the programs as ops:
loading imports ``densereg_torch.ops``, which registers them, and no module
of ``densereg_torch.models``. On a CUDA program the ops launch the
hand-written kernels; a CPU program runs their plain versions.

File layout (the JAX artifact's): 8-byte magic, 4-byte big-endian JSON
header length, the JSON header (batch contract, camera, joint count, the
programs' table), then the serialized programs. The magic is the port's
own, so neither package takes the other's artifact for its own. The first
blob is the float32 program at ``max_batch`` of the first platform and,
with ``u16``, the second its uint16 one (``f32_len``/``u16_len``, with
``sha256``/``sha256_u16``); a ladder of buckets or a second platform adds
``blob_table``, one row a blob (``platform``, ``batch``, ``dtype``,
``len``, ``sha256``), every blob in file order.

The loaded programs run eagerly, as the live predictor does; compiling
them (AOTInductor) is left to later work.
"""

from __future__ import annotations

import copy
import hashlib
import io
import json
import struct
from typing import Optional, Sequence

import numpy as np
import torch

from densereg_torch.host_loop import HostLoop, bucket_ladder

_MAGIC = b"DRTORCH1"


def _program(module, bucket: int, frame_hw, dtype: str, device) -> bytes:
    """``torch.export`` of ``module`` at one (bucket, frame dtype), as
    bytes."""
    h, w = frame_hw
    frames = torch.zeros((bucket, h, w, 1), device=device, dtype=(
        torch.uint16 if dtype == "u16" else torch.float32))
    bbxs = torch.zeros((bucket, 5), dtype=torch.float32, device=device)
    with torch.no_grad():
        ep = torch.export.export(module, (frames, bbxs))
    # the program keeps its example inputs by default: a bucket of frames
    # (78 MB at 256 float32 frames of 240x320) that no caller needs
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def export_predictor(predictor, path: str,
                     frame_hw: Optional[tuple] = None,
                     platforms: Optional[Sequence[str]] = None,
                     u16: bool = True,
                     batch_buckets: Optional[Sequence[int]] = None) -> None:
    """Serialize ``predictor``'s serving program with its weights.

    Args:
      predictor: a :class:`densereg_torch.serving.Predictor` (float32,
        bfloat16 or int8).
      frame_hw: raw frame (H, W); defaults to the camera's sensor size.
      platforms: ``"cuda"`` and/or ``"cpu"``; defaults to the predictor's
        device. A platform other than the predictor's exports a copy of its
        program moved there; ``"cuda"`` needs a card.
      u16: also export the uint16-frames entry (integer-mm depth, cast on
        the device). The weights are baked into every program, so each
        entry adds about one weights' worth of bytes.
      batch_buckets: the dispatch sizes to export (``max_batch`` is always
        one); defaults to the predictor's ``batch_buckets``.
    """
    from densereg_torch.models.layers import pack_weights

    cam = predictor.camera
    h, w = frame_hw if frame_hw is not None else (int(cam.h), int(cam.w))
    b = predictor.max_batch
    if batch_buckets is None:
        batch_buckets = predictor.batch_buckets
    buckets = bucket_ladder(batch_buckets, b)
    if platforms is None:
        platforms = (predictor.device.type,)
    platforms = tuple(platforms)
    dtypes = ("f32", "u16") if u16 else ("f32",)

    # blob order is part of the format: f32 then u16 at max_batch of the
    # first platform (the legacy two-blob layout), then the other buckets
    # ascending, then each further platform in the same order
    blobs = []
    for platform in platforms:
        if platform not in ("cuda", "cpu"):
            raise ValueError(f"platforms must name 'cuda' or 'cpu', got "
                             f"{platform!r}")
        if platform == predictor.device.type:
            module, device = predictor.module, predictor.device
        else:
            if platform == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("export for 'cuda' needs a card")
            device = torch.device(platform)
            module = copy.deepcopy(predictor.module).to(device)
        pack_weights(module.eval())
        for bb in [b] + [v for v in buckets if v != b]:
            for dt in dtypes:
                blobs.append((platform, str(device), bb, dt,
                              _program(module, bb, (h, w), dt, device)))

    header = {
        "max_batch": b,
        "frame_hw": [h, w],
        "num_joint": int(predictor.net_cfg.num_joint),
        "camera": [float(v) for v in np.asarray(cam.as_array(), np.float64)],
        "compute_dtype": predictor.net_cfg.compute_dtype,
        "quantized": bool(predictor.net_cfg.quantize),
        "platforms": list(platforms),
        "devices": {p: d for p, d, _, _, _ in blobs},
        "sha256": hashlib.sha256(blobs[0][4]).hexdigest(),
        "f32_len": len(blobs[0][4]),
    }
    if u16:
        header["u16_len"] = len(blobs[1][4])
        header["sha256_u16"] = hashlib.sha256(blobs[1][4]).hexdigest()
    if len(buckets) > 1:
        header["batch_buckets"] = buckets
    if len(blobs) > len(dtypes):
        header["blob_table"] = [
            {"platform": p, "batch": bb, "dtype": dt, "len": len(data),
             "sha256": hashlib.sha256(data).hexdigest()}
            for p, _, bb, dt, data in blobs]
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack(">I", len(hdr)))
        f.write(hdr)
        for blob in blobs:
            f.write(blob[4])


class ExportedPredictor(HostLoop):
    """Callable loaded from an export artifact: the surface of
    :class:`densereg_torch.serving.Predictor` (``max_batch``, ``frame_hw``,
    ``num_joint``, ``camera``, ``batch_buckets``, ``accepts_u16``, and
    ``host_loop.HostLoop``'s ``warmup``, ``_dispatch`` and double-buffered
    ``__call__``) over the loaded programs, so that
    ``densereg_torch.serve.Server`` serves it unchanged."""

    def __init__(self, programs: dict, header: dict, device: torch.device):
        """``programs`` maps ``(batch, "f32"|"u16")`` to a loaded
        ``torch.export`` program of ``device``'s platform."""
        self.max_batch = int(header["max_batch"])
        self.frame_hw = tuple(header["frame_hw"])
        self.num_joint = int(header["num_joint"])
        self.camera = np.asarray(header["camera"], np.float32)
        self.platforms = tuple(header.get("platforms", ()))
        self.device = device
        self.batch_buckets = tuple(sorted(
            {bb for bb, dt in programs if dt == "f32"}))
        self.accepts_u16 = all(
            (bb, "u16") in programs for bb in self.batch_buckets)
        if (device.type == "cuda"
                and header.get("compute_dtype") == "float32"):
            # as the live float32 predictor: no TF32 in cuDNN's convolutions
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self._calls = {key: ep.module() for key, ep in programs.items()}

    def _predict(self, frames: torch.Tensor,
                 bbxs: torch.Tensor) -> torch.Tensor:
        """The loaded program of the chunk's (bucket, frame dtype)."""
        dt = "u16" if frames.dtype == torch.uint16 else "f32"
        with torch.inference_mode():
            return self._calls[(frames.shape[0], dt)](frames, bbxs)


def read_artifact(path: str):
    """The header of an artifact and its blobs, each checked against its
    sha256: a list of ``(platform, batch, dtype, bytes)``. Raises
    ``ValueError`` naming the blob whose bytes do not match."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"{path}: not a densereg_torch export artifact")
        (hlen,) = struct.unpack(">I", f.read(4))
        header = json.loads(f.read(hlen).decode())
        raw = f.read()

    def checked(data, want, what):
        got = hashlib.sha256(data).hexdigest()
        if got != want:
            raise ValueError(f"{path}: {what} blob corrupted (sha256 "
                             f"{got[:12]}... != header {want[:12]}...)")
        return data

    platform = header["platforms"][0]
    b = int(header["max_batch"])
    if "blob_table" in header:
        blobs, off = [], 0
        for row in header["blob_table"]:
            data = raw[off:off + row["len"]]
            off += row["len"]
            what = f"{row['platform']}/b{row['batch']}/{row['dtype']}"
            blobs.append((row["platform"], int(row["batch"]), row["dtype"],
                          checked(data, row["sha256"], what)))
        return header, blobs
    n32 = header["f32_len"]
    blobs = [(platform, b, "f32",
              checked(raw[:n32], header["sha256"], f"{platform}/b{b}/f32"))]
    if "u16_len" in header:
        blobs.append((platform, b, "u16",
                      checked(raw[n32:n32 + header["u16_len"]],
                              header["sha256_u16"], f"{platform}/b{b}/u16")))
    return header, blobs


def load_exported(path: str, device=None) -> ExportedPredictor:
    """Load an artifact of :func:`export_predictor` to run on ``device``
    (default: the artifact's first platform). The artifact must hold
    programs of the device's platform, exported on that device."""
    import densereg_torch.ops  # noqa: F401  (registers the custom ops)

    header, blobs = read_artifact(path)
    device = torch.device(device if device is not None
                          else header["platforms"][0])
    if device.type not in header["platforms"]:
        raise ValueError(f"{path}: no program for {device.type} (the "
                         f"artifact has {header['platforms']})")
    exported_on = torch.device(header["devices"][device.type])
    if device.type == "cuda" and device.index is None:
        device = exported_on
    if device != exported_on:
        raise ValueError(f"{path}: its {device.type} programs run on "
                         f"{exported_on}, not {device}")
    programs = {(bb, dt): torch.export.load(io.BytesIO(data))
                for p, bb, dt, data in blobs if p == device.type}
    return ExportedPredictor(programs, header, device)
