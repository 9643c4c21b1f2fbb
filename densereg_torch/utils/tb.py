"""TensorBoard event files, written and read without TensorFlow.

A copy of ``densereg_tpu/utils/tb.py`` (pure numpy), so that the port
imports nothing of the JAX package: the files of the two packages are the
same records byte for byte but the wall times. The reference's summaries
are scalar losses and the learning rate, weight and gradient histograms,
and rendered images (its ``model/train_single_gpu.py`` and
``data/visualization.py``); this module hand-encodes the three protobuf
messages involved (Event, Summary, HistogramProto) and the TFRecord
framing (a length and a masked crc32c header a record), so a stock
TensorBoard reads the file.

Wire-format facts encoded below (stable since TF 1.x):
  * record: u64 LE length, u32 LE masked crc32c(length bytes), payload,
    u32 LE masked crc32c(payload); masked = ((c>>15 | c<<17) + 0xa282ead8).
  * Event: wall_time=1 (double), step=2 (int64), file_version=3 (string),
    summary=5 (message); first record is file_version="brain.Event:2".
  * Summary.Value: tag=1, simple_value=2 (float), image=4, histo=5.
  * Summary.Image: height=1, width=2, colorspace=3 (1=gray, 3=RGB, 4=RGBA),
    encoded_image_string=4 (PNG bytes).
  * HistogramProto: min=1, max=2, num=3, sum=4, sum_squares=5 (doubles),
    bucket_limit=6, bucket=7 (packed doubles).
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib
from typing import Iterator, Optional

import numpy as np

try:  # google-crc32c where it is installed; pure Python otherwise
    import google_crc32c

    def _crc32c(data: bytes) -> int:
        return google_crc32c.value(data)
except ImportError:
    _CRC_TABLE = []
    for _i in range(256):
        _c = _i
        for _ in range(8):
            _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
        _CRC_TABLE.append(_c)

    def _crc32c(data: bytes) -> int:
        crc = 0xFFFFFFFF
        for b in data:
            crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, n: int) -> bytes:
    if n < 0:  # int64 two's complement (steps are never negative here)
        n += 1 << 64
    return _key(field, 0) + _varint(n)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_bytes(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def _f_packed_doubles(field: int, arr) -> bytes:
    arr = np.asarray(arr, "<f8")
    return _f_bytes(field, arr.tobytes())


# ---------------------------------------------------------------------------
# histogram buckets (TF's default exponential grid)
# ---------------------------------------------------------------------------

def _make_limits() -> np.ndarray:
    pos = []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    return np.asarray([-x for x in reversed(pos)] + pos
                      + [np.finfo(np.float64).max])


_LIMITS = _make_limits()


def histogram_proto(values) -> bytes:
    """Encode a HistogramProto for an array of values."""
    v = np.asarray(values, np.float64).ravel()
    v = v[np.isfinite(v)]
    if v.size == 0:
        v = np.zeros((1,))
    idx = np.searchsorted(_LIMITS, v, side="left")
    counts = np.bincount(idx, minlength=len(_LIMITS)).astype(np.float64)
    nz = np.nonzero(counts)[0]
    lo, hi = int(nz[0]), int(nz[-1])
    return (_f_double(1, float(v.min())) + _f_double(2, float(v.max()))
            + _f_double(3, float(v.size)) + _f_double(4, float(v.sum()))
            + _f_double(5, float(np.square(v).sum()))
            + _f_packed_doubles(6, _LIMITS[lo:hi + 1])
            + _f_packed_doubles(7, counts[lo:hi + 1]))


# ---------------------------------------------------------------------------
# PNG encoding (for image summaries; no PIL/matplotlib dependency)
# ---------------------------------------------------------------------------

def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (h, w), (h, w, 1), (h, w, 3) or (h, w, 4) -> PNG bytes."""
    arr = np.ascontiguousarray(arr, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)],
        axis=1).tobytes()  # filter byte 0 per scanline
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class EventWriter:
    """Append-only TensorBoard event file under ``logdir``."""

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        name = "events.out.tfevents.%d.%s%s" % (
            int(time.time()), socket.gethostname(), filename_suffix)
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._event(_f_bytes(3, b"brain.Event:2"), flush=True)

    def _record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + data + struct.pack("<I", _masked_crc(data)))

    def _event(self, body: bytes, step: Optional[int] = None,
               flush: bool = False) -> None:
        ev = _f_double(1, time.time())
        if step is not None:
            ev += _f_varint(2, int(step))
        self._record(ev + body)
        if flush:
            self._f.flush()

    def _summary(self, value_bytes: bytes, step: int) -> None:
        self._event(_f_bytes(5, _f_bytes(1, value_bytes)), step=step)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._summary(_f_bytes(1, tag.encode()) + _f_float(2, float(value)),
                      step)

    def add_scalars(self, scalars: dict, step: int) -> None:
        for tag, value in scalars.items():
            self.add_scalar(tag, value, step)

    def add_histogram(self, tag: str, values, step: int) -> None:
        self._summary(_f_bytes(1, tag.encode())
                      + _f_bytes(5, histogram_proto(values)), step)

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """image: uint8 (h, w[, c]) or float in [0, 1]."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        h, w, c = img.shape
        payload = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, c)
                   + _f_bytes(4, encode_png(img)))
        self._summary(_f_bytes(1, tag.encode()) + _f_bytes(4, payload), step)

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.flush()
        self._f.close()


# ---------------------------------------------------------------------------
# reader (tests / offline tooling)
# ---------------------------------------------------------------------------

def _iter_fields(buf: bytes):
    i, n = 0, len(buf)
    while i < n:
        tag, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                val |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            val = struct.unpack("<d", buf[i:i + 8])[0]
            i += 8
        elif wire == 5:
            val = struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        elif wire == 2:
            ln, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            val = buf[i:i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_value(buf: bytes) -> dict:
    out = {}
    for field, _, val in _iter_fields(buf):
        if field == 1:
            out["tag"] = val.decode()
        elif field == 2:
            out["simple_value"] = val
        elif field == 4:
            img = {}
            for f2, _, v2 in _iter_fields(val):
                img[{1: "height", 2: "width", 3: "colorspace",
                     4: "png"}.get(f2, f2)] = v2
            out["image"] = img
        elif field == 5:
            histo = {}
            for f2, w2, v2 in _iter_fields(val):
                name = {1: "min", 2: "max", 3: "num", 4: "sum",
                        5: "sum_squares", 6: "bucket_limit",
                        7: "bucket"}.get(f2, f2)
                if f2 in (6, 7):
                    histo[name] = np.frombuffer(v2, "<f8")
                else:
                    histo[name] = v2
            out["histo"] = histo
    return out


def read_events(path: str, check_crc: bool = True) -> Iterator[dict]:
    """Yield dicts {wall_time, step, file_version?|values?} per event."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            hcrc = struct.unpack("<I", f.read(4))[0]
            if check_crc and hcrc != _masked_crc(header):
                raise IOError("corrupt record header")
            (length,) = struct.unpack("<Q", header)
            data = f.read(length)
            dcrc = struct.unpack("<I", f.read(4))[0]
            if check_crc and dcrc != _masked_crc(data):
                raise IOError("corrupt record payload")
            ev = {}
            for field, _, val in _iter_fields(data):
                if field == 1:
                    ev["wall_time"] = val
                elif field == 2:
                    ev["step"] = val
                elif field == 3:
                    ev["file_version"] = val.decode()
                elif field == 5:
                    values = [
                        _parse_value(v) for f2, _, v in _iter_fields(val)
                        if f2 == 1]
                    ev["values"] = values
            yield ev
