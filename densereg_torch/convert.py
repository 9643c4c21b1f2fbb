"""Reference TF-1.x checkpoints to the port's weights, and the converted
payload on disk.

A copy of ``densereg_tpu/convert.py`` without Flax. The reference names its
convolution variables by creation order (``Conv``, ``Conv_1``, ... at the
root scope, ``hg_imgproc/Conv_k`` for the stem, each with a nested
``BatchReNorm/{beta,gamma,moving_mean,moving_variance,...,curr_t}``), and
the network's modules are created in the same order, so the mapping walks
both in step: :func:`model_conv_order` against :func:`tf_conv_scopes`.

The payload, ``{"params", "batch_stats", "renorm_t"}`` in the Flax layout
that ``models.from_flax`` reads, is stored as Flax stores it
(``flax.serialization.msgpack_serialize``), so a file written by either
package reads in the other. Neither Flax nor ``msgpack`` is needed: the few
msgpack types the payload uses are coded here in Python (:func:`packb`,
:func:`unpackb`), with Flax's extension types for arrays (1) and numpy
scalars (3), an array being ``(shape, dtype name, C-order bytes)`` packed
inside. TensorFlow is imported only by :func:`convert`, which runs on the
CPU:

    save_converted(convert("exp/train_cache/<run>/model.ckpt-219999",
                           num_stack=2, num_fea=128, num_joint=16),
                   "icvl_params.msgpack")
"""

from __future__ import annotations

import re
import struct
from typing import Dict, List, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# ---------------------------------------------------------------------------
# creation-order walk of the network (must mirror DenseRegNet's modules)
# ---------------------------------------------------------------------------

def residual_convs(name: str, num_in: int, num_out: int) -> List[Tuple[str, bool]]:
    """Conv sub-modules of a Residual in creation order: conv1/conv2/conv3
    (+ shortcut when channels change), all with renorm."""
    mods = [(f"{name}/conv1", True), (f"{name}/conv2", True),
            (f"{name}/conv3", True)]
    if num_in != num_out:
        mods.append((f"{name}/shortcut", True))
    return mods


def hourglass_convs(name: str, depth: int, fea: int) -> List[Tuple[str, bool]]:
    """upper -> lower_in -> inner... -> lower_out (reference um_v1.py:51-69)."""
    mods = residual_convs(f"{name}/upper", fea, fea)
    mods += residual_convs(f"{name}/lower_in", fea, fea)
    if depth > 1:
        mods += hourglass_convs(f"{name}/inner", depth - 1, fea)
    mods += residual_convs(f"{name}/lower_out", fea, fea)
    return mods


def model_conv_order(num_stack: int, num_fea: int, num_joint: int,
                     hg_depth: int = 4) -> List[Tuple[str, bool]]:
    """(module path, has_renorm) for every conv, in creation order == the
    reference's TF-variable numbering order."""
    mods: List[Tuple[str, bool]] = [("stem_conv", True)]
    mods += residual_convs("stem_res1", 32, 64)
    mods += residual_convs("stem_res2", 64, 64)
    mods += residual_convs("stem_res3", 64, num_fea)
    j = num_joint
    for i in range(num_stack):
        s = f"_s{i}"
        mods += hourglass_convs("hg" + s, hg_depth, num_fea)
        mods += residual_convs("ll_res" + s, num_fea, num_fea)
        mods += [("ll_conv" + s, True), ("hm_head" + s, False)]
        mods += residual_convs("hm3_res" + s, num_fea + 3, 128)
        mods += [("hm3_head" + s, False)]
        cat = num_fea + 2 * j
        mods += residual_convs("um_resA" + s, cat, 256)
        mods += residual_convs("um_resB" + s, 256, 256)
        mods += residual_convs("umm_resA" + s, cat, 256)
        mods += residual_convs("umm_resB" + s, 256, 256)
        mods += residual_convs("um_comb" + s, 512, 512)
        mods += [("um_fc1" + s, False), ("um_fc2" + s, False),
                 ("um_head" + s, False)]
        if i < num_stack - 1:
            mods += [("inter_out" + s, False), ("inter_ll" + s, False)]
    return mods


# ---------------------------------------------------------------------------
# TF checkpoint side
# ---------------------------------------------------------------------------

def tf_conv_scopes(var_names) -> List[str]:
    """Conv scopes of the reference graph sorted in creation order: the stem
    lives under hg_imgproc/ (created first), the rest at root; auto-suffix
    `_N` encodes creation order within each scope."""
    def order_key(scope):
        m = re.match(r"(.*?)Conv(?:_(\d+))?$", scope)
        idx = int(m.group(2)) if m.group(2) else 0
        return idx

    scopes = sorted({m.group(1) for name in var_names
                     for m in [re.match(r"((?:hg_imgproc/)?Conv(?:_\d+)?)/",
                                        name)] if m})
    stem = sorted([s for s in scopes if s.startswith("hg_imgproc/")],
                  key=order_key)
    root = sorted([s for s in scopes if not s.startswith("hg_imgproc/")],
                  key=order_key)
    return stem + root


def convert(ckpt_path: str, num_stack: int, num_fea: int, num_joint: int,
            hg_depth: int = 4):
    import tensorflow as tf

    reader = tf.train.load_checkpoint(ckpt_path)
    shape_map = reader.get_variable_to_shape_map()
    names = list(shape_map)

    order = model_conv_order(num_stack, num_fea, num_joint, hg_depth)
    scopes = tf_conv_scopes(names)
    if len(scopes) != len(order):
        raise ValueError(
            f"checkpoint has {len(scopes)} conv scopes but the model "
            f"expects {len(order)} — wrong --num_stack/--num_fea/--num_joint?")

    params: Dict = {}
    batch_stats: Dict = {}
    renorm_t = 0.0

    def put(tree, path, leaf):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    for (module, has_bn), scope in zip(order, scopes):
        mpath = module.split("/")
        w = reader.get_tensor(scope + "/weights")
        put(params, mpath + ["conv", "kernel"], np.asarray(w, np.float32))
        if has_bn:
            bn = scope + "/BatchReNorm/"
            put(params, mpath + ["bn", "beta"],
                np.asarray(reader.get_tensor(bn + "beta"), np.float32))
            gname = bn + "gamma"
            gamma = (np.asarray(reader.get_tensor(gname), np.float32)
                     if gname in shape_map
                     else np.ones(w.shape[-1], np.float32))
            put(params, mpath + ["bn", "gamma"], gamma)
            put(batch_stats, mpath + ["bn", "mean"],
                np.asarray(reader.get_tensor(bn + "moving_mean"), np.float32))
            put(batch_stats, mpath + ["bn", "var"],
                np.asarray(reader.get_tensor(bn + "moving_variance"),
                           np.float32))
            tname = bn + "curr_t"
            if tname in shape_map:
                renorm_t = float(np.asarray(reader.get_tensor(tname))
                                 .reshape(-1)[0])
        else:
            put(params, mpath + ["conv", "bias"],
                np.asarray(reader.get_tensor(scope + "/biases"), np.float32))

    return {"params": params, "batch_stats": batch_stats,
            "renorm_t": renorm_t}


# ---------------------------------------------------------------------------
# msgpack, as Flax writes and reads it
# ---------------------------------------------------------------------------

def _pack_len(out: bytearray, n: int, fix: Tuple[int, int], *wide) -> None:
    """A length header: the fixed form ``fix = (tag, limit)`` when ``n``
    is under its limit, else the first of ``wide`` (tag, struct format)
    whose width holds ``n``."""
    tag, limit = fix
    if n < limit:
        out.append(tag | n)
        return
    for tag, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            out += bytes([tag]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v >= 0:
        for tag, fmt in ((0xcc, ">B"), (0xcd, ">H"), (0xce, ">I"),
                         (0xcf, ">Q")):
            if v < 1 << (8 * struct.calcsize(fmt)):
                out += bytes([tag]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit msgpack's uint64")
    else:
        for tag, fmt in ((0xd0, ">b"), (0xd1, ">h"), (0xd2, ">i"),
                         (0xd3, ">q")):
            if v >= -(1 << (8 * struct.calcsize(fmt) - 1)):
                out += bytes([tag]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"{v} does not fit msgpack's int64")


def _pack_array_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, np.ndarray) or isinstance(obj, np.generic):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        data = _pack_array_bytes(np.asarray(obj))
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            _pack_len(out, len(data), (0, 0), (0xc7, ">B"), (0xc8, ">H"),
                      (0xc9, ">I"))
        out += struct.pack(">b", code) + data
    elif type(obj) is int:
        _pack_int(out, obj)
    elif type(obj) is float:
        out += b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), (0xa0, 32), (0xd9, ">B"), (0xda, ">H"),
                  (0xdb, ">I"))
        out += data
    elif type(obj) in (bytes, bytearray):
        _pack_len(out, len(obj), (0, 0), (0xc4, ">B"), (0xc5, ">H"),
                  (0xc6, ">I"))
        out += obj
    elif type(obj) is list:
        _pack_len(out, len(obj), (0x90, 16), (0xdc, ">H"), (0xdd, ">I"))
        for item in obj:
            _pack(out, item)
    elif type(obj) is dict:
        _pack_len(out, len(obj), (0x80, 16), (0xde, ">H"), (0xdf, ">I"))
        for key, val in sorted(obj.items()):
            _pack(out, key)
            _pack(out, val)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} as msgpack")


def packb(obj) -> bytes:
    """msgpack bytes of a tree of dicts, lists, str, bytes, int, float,
    bool, None, numpy arrays (extension 1) and numpy scalars (extension 3),
    as ``flax.serialization.msgpack_serialize`` codes them: every dict's
    keys in sorted order (Flax's copy of the tree sorts them), strings as
    str and bytes as bin; a tuple raises, as it does in Flax."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack extension type {code}")
        shape, dtype, buf = unpackb(data)
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape,
                                                                order="C")
        return arr if code == _EXT_NDARRAY else arr[()]

    def obj(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if b < 0x90:
            return self.map_(b & 0x0f)
        if b < 0xa0:
            return [self.obj() for _ in range(b & 0x0f)]
        if b < 0xc0:
            return self.str_(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", self.take), 0xc5: (">H", self.take),
                 0xc6: (">I", self.take), 0xc7: (">B", self.ext),
                 0xc8: (">H", self.ext), 0xc9: (">I", self.ext),
                 0xd9: (">B", self.str_), 0xda: (">H", self.str_),
                 0xdb: (">I", self.str_),
                 0xdc: (">H", lambda n: [self.obj() for _ in range(n)]),
                 0xdd: (">I", lambda n: [self.obj() for _ in range(n)]),
                 0xde: (">H", self.map_), 0xdf: (">I", self.map_)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        scalars = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xd4 <= b <= 0xd8:
            return self.ext(1 << (b - 0xd4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def unpackb(data: bytes):
    """The object of msgpack ``data``, decoded as
    ``flax.serialization.msgpack_restore`` decodes it: arrays read back as
    read-only numpy arrays on the bytes, numpy scalars as numpy scalars.
    Trailing bytes raise."""
    reader = _Reader(data)
    obj = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return obj


def save_converted(payload, out_path: str) -> None:
    """Write ``payload`` as ``flax.serialization.msgpack_serialize`` would."""
    with open(out_path, "wb") as f:
        f.write(packb(payload))


def load_converted(path: str):
    """Read a payload written by :func:`save_converted` or by the JAX
    package's ``save_converted`` (``flax.serialization.msgpack_restore``)."""
    with open(path, "rb") as f:
        return unpackb(f.read())
