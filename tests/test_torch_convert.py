"""Converted weights in the port: its msgpack codec against Flax's, both
directions, byte for byte; the TF1 checkpoint converter of both packages;
``Predictor.from_converted``; the payload's shape check; and a training
run warm-started from a payload.

The port reads and writes the payload without Flax or ``msgpack``
(``densereg_torch/convert.py``), so every case here is held to the bytes
that ``flax.serialization.msgpack_serialize`` writes and to the tree that
``msgpack_restore`` reads.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from flax import serialization  # noqa: E402

from densereg_tpu.convert import convert as jconvert  # noqa: E402
from densereg_tpu.convert import save_converted as jsave_converted  # noqa: E402

from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch import convert as tconvert  # noqa: E402
from densereg_torch.config import TrainConfig, model_desc  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.models import DenseRegNet, init_variables, to_flax  # noqa: E402
from densereg_torch.train import CheckpointManager, train  # noqa: E402
from densereg_torch.train import loop as tloop  # noqa: E402
from tests.test_torch_serving import _hand_frames  # noqa: E402

SHAPE = dict(num_stack=1, num_fea=8, num_joint=16, input_hw=(32, 32))
NET = NetConfig(**SHAPE)
ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
quiet = lambda *_: None  # noqa: E731


def _trees():
    """Trees of every type the codec takes, each at the widths where
    msgpack changes its header (fixed forms, then 8-, 16- and 32-bit
    lengths)."""
    rng = np.random.default_rng(0)
    payload = {
        "params": {"stem_conv": {"conv": {"kernel": rng.normal(
            size=(3, 3, 1, 32)).astype(np.float32)},
            "bn": {"beta": rng.normal(size=32).astype(np.float32),
                   "gamma": np.ones(32, np.float32)}},
            "um_head_s0": {"conv": {"kernel": rng.normal(
                size=(1, 1, 256, 48)).astype(np.float32),
                "bias": np.zeros(48, np.float32)}}},
        "batch_stats": {"stem_conv": {"bn": {
            "mean": rng.normal(size=32).astype(np.float32),
            "var": rng.uniform(0.5, 2, 32).astype(np.float32)}}},
    }
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    return {
        "payload_float_renorm_t": {**payload, "renorm_t": 12345.678},
        "payload_numpy_renorm_t": {**payload,
                                   "renorm_t": np.float32(12345.678)},
        "scalars": {"ints": ints, "floats": [0.0, -1.5, 1e300, math.inf,
                                             math.nan],
                    "none": None, "flags": [True, False],
                    "np": [np.float32(0.25), np.float64(-2.0), np.int8(-3),
                           np.uint16(7), np.bool_(True), np.int64(2 ** 40)]},
        "lengths": {"str": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                            "e" * 65535, "f" * 65536, "é✓"],
                    "bin": [b"", b"x" * 255, b"y" * 256, b"z" * 65536],
                    "list16": list(range(16)),
                    "list65536": [0] * 65536,
                    "map16": {f"k{i:02d}": i for i in range(16)},
                    "map65536": {f"{i:05d}": None for i in range(65536)}},
        "arrays": {"f64": rng.normal(size=(2, 3)),
                   "i8": rng.integers(-128, 128, (5, 7)).astype(np.int8),
                   "u16": rng.integers(0, 65535, 9).astype(np.uint16),
                   "bool": np.asarray([True, False]),
                   "zero_d": np.asarray(3.5, np.float32),
                   "empty": np.zeros((0, 3), np.float32),
                   "one_byte": np.zeros(1, np.uint8),   # fixext widths
                   "fortran": np.asfortranarray(rng.normal(size=(3, 4))),
                   "ext16": np.zeros(300, np.uint8),
                   "ext32": rng.normal(size=20000).astype(np.float32)},
    }


def _assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want), (path, type(got), type(want))
        assert got == want or (got != got and want != want), path


@pytest.mark.parametrize("name", sorted(_trees()))
def test_codec_writes_flax_bytes(name):
    tree = _trees()[name]
    assert (tconvert.packb(tree)
            == serialization.msgpack_serialize(tree))


@pytest.mark.parametrize("name", sorted(_trees()))
def test_codec_reads_flax_and_flax_reads_it(name):
    tree = _trees()[name]
    _assert_same(tconvert.unpackb(serialization.msgpack_serialize(tree)), tree)
    _assert_same(serialization.msgpack_restore(
        tconvert.packb(tree)), tree)


def test_load_and_save_converted_across_packages(tmp_path):
    tree = _trees()["payload_numpy_renorm_t"]
    jsave_converted(tree, str(tmp_path / "jax.msgpack"))
    tconvert.save_converted(tree, str(tmp_path / "torch.msgpack"))
    assert ((tmp_path / "jax.msgpack").read_bytes()
            == (tmp_path / "torch.msgpack").read_bytes())
    _assert_same(tconvert.load_converted(str(tmp_path / "jax.msgpack")), tree)
    with pytest.raises(ValueError, match="extra bytes"):
        tconvert.unpackb(tconvert.packb({}) + b"\xc0")
    with pytest.raises(ValueError, match="truncated"):
        tconvert.unpackb(tconvert.packb({"a": "bcd"})[:-1])
    with pytest.raises(TypeError, match="cannot pack"):
        tconvert.packb({"a": (1, 2)})


def test_tf1_checkpoint_converts_as_in_jax(tmp_path):
    """A TF1 checkpoint in the reference graph's creation order and names
    (``tests/ref_tf_graph.py``, as ``tests/test_tf_converter_real.py``
    writes it): both packages' ``convert`` give the same payload, and the
    same file; the port's net takes it."""
    tf = pytest.importorskip("tensorflow")
    from tests.ref_tf_graph import GraphSpec, RefGraphEmulator

    spec = GraphSpec(j=3, fea=8, stack=2, k=3, in_hw=32, hg_depth=2)
    em = RefGraphEmulator(np.random.default_rng(0), spec, tf)
    graph = tf.Graph()
    with graph.as_default():
        em.build()
        saver = tf.compat.v1.train.Saver()
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            ckpt = saver.save(sess, str(tmp_path / "model.ckpt"),
                              global_step=219999)
    args = dict(num_stack=spec.stack, num_fea=spec.fea, num_joint=spec.j,
                hg_depth=spec.hg_depth)
    ours, theirs = tconvert.convert(ckpt, **args), jconvert(ckpt, **args)
    _assert_same(ours, theirs)
    assert ours["renorm_t"] == pytest.approx(spec.curr_t)
    tconvert.save_converted(ours, str(tmp_path / "t.msgpack"))
    jsave_converted(theirs, str(tmp_path / "j.msgpack"))
    assert ((tmp_path / "t.msgpack").read_bytes()
            == (tmp_path / "j.msgpack").read_bytes())
    net = DenseRegNet(NetConfig(num_stack=2, num_fea=8, num_joint=3,
                                input_hw=(32, 32)))
    tloop._load_converted_into(net, ours, "converted")
    assert torch.equal(net.stem_conv.conv.kernel, torch.from_numpy(
        ours["params"]["stem_conv"]["conv"]["kernel"]).permute(3, 2, 0, 1))


@pytest.fixture(scope="module")
def payload(tmp_path_factory):
    """Seeded variables written by the JAX package's ``save_converted``."""
    path = str(tmp_path_factory.mktemp("payload") / "params.msgpack")
    variables = init_variables(NET, seed=5)
    jsave_converted({**variables, "renorm_t": np.float32(4321.5)}, path)
    return variables, path


@pytest.mark.parametrize("quantize", [False, True])
def test_from_converted_serves_as_the_variables(payload, quantize):
    variables, path = payload
    frames, bbxs = _hand_frames(np.random.default_rng(3), 5)
    kw = dict(max_batch=4, device="cpu", quantize=quantize,
              calibration=(frames, bbxs) if quantize else None)
    got = Predictor.from_converted(path, NET, ICVL, **kw)
    want = Predictor(variables, NET, ICVL, **kw)
    assert got.net_cfg.quantize == quantize
    out = got(frames, bbxs)
    assert out.shape == (5, 48) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, want(frames, bbxs))


def test_param_shape_check_names_the_mismatch(payload):
    variables, path = payload
    wide = DenseRegNet(NetConfig(**{**SHAPE, "num_fea": 16}))
    with pytest.raises(ValueError,
                       match=r"shape mismatch at \w+/.*: \(.*\) vs \(.*\)"):
        tloop._assert_param_shapes(wide, variables["params"], path)
    deep = DenseRegNet(NetConfig(**{**SHAPE, "num_stack": 2}))
    with pytest.raises(ValueError, match=r"missing \['hg_s1/") as info:
        tloop._assert_param_shapes(deep, variables["params"], path)
    assert "unexpected []" in str(info.value)
    tloop._assert_param_shapes(DenseRegNet(NET), variables["params"], path)
    spec = synthetic.make_spec("testing", directory=os.path.join(
        os.path.dirname(path), "synth"), num_shards=1, samples_per_shard=2)
    with pytest.raises(ValueError, match="shape mismatch"):
        tloop.test(spec, NetConfig(**{**SHAPE, "num_fea": 16}),
                   TrainConfig(base_dir=os.path.dirname(path)),
                   init_params=path, device="cpu", log_fn=quiet)


def test_train_warm_starts_from_a_payload(payload, tmp_path):
    """Step 0, a fresh optimizer, the payload's parameters, statistics and
    renorm clock, the EMA seeded with the parameters; a checkpoint restore
    takes precedence over the payload."""
    variables, path = payload
    spec = synthetic.make_spec("training", directory=str(tmp_path / "synth"),
                               num_shards=1, samples_per_shard=4)
    tcfg = TrainConfig(batch_size=2, sub_batch=1, base_dir=str(tmp_path),
                       ema_decay=0.9)
    state = train(spec, NET, tcfg, max_steps=0, init_params=path,
                  device="cpu", log_fn=quiet)
    assert state.step == 0 and state.optimizer.count == 0
    assert not state.optimizer.state
    assert float(state.renorm_t) == 4321.5
    _assert_same(to_flax(state.net), {k: variables[k]
                                      for k in ("params", "batch_stats")})
    for k, p in state.net.named_parameters():
        assert torch.equal(state.ema[k], p) and state.ema[k] is not p

    state = train(spec, NET, tcfg, max_steps=1, init_params=path,
                  device="cpu", log_fn=quiet)
    assert state.step == 1
    run = os.path.join(str(tmp_path), model_desc(spec.name, spec.subset, NET,
                                                 tcfg.augment))
    saved = CheckpointManager(os.path.join(run, "ckpt")).load()["net"]
    resumed = train(spec, NET, tcfg, max_steps=1, init_params=path,
                    restore_step="auto", device="cpu", log_fn=quiet)
    assert resumed.step == 1
    for k, v in resumed.net.state_dict().items():
        assert torch.equal(v, saved[k]), k
