"""The uint16 wire (``densereg_torch.wire``) and the host-preprocess paths
of the input pipelines, ``train()`` and ``test()``.

The codec is bit-equal to ``densereg_tpu.wire``. A host-preprocessed
float32 batch equals the device-crop batch on the CPU but the center of
mass (summed on another thread, within 1e-6 relative); a uint16-wire crop
is within half a quantization step of it plus the codec's float32 rounding
(``wire.error_bound``: ``max / 65535 * 0.5117``; ``tests/test_wire.py``
holds the JAX codec to 0.502 on its data, where the rounding is smaller).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_tpu import wire as jwire  # noqa: E402

from densereg_torch import wire  # noqa: E402
from densereg_torch.config import EvalConfig, NetConfig, TrainConfig  # noqa: E402
from densereg_torch.convert import save_converted  # noqa: E402
from densereg_torch.data import InputPipeline, synthetic  # noqa: E402
from densereg_torch.data import TestPipeline as FramePipeline  # noqa: E402
from densereg_torch.eval import read_result_file  # noqa: E402
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.train import train  # noqa: E402
from densereg_torch.train.loop import test as run_test  # noqa: E402

quiet = lambda *_: None
NET = NetConfig(num_stack=1, num_fea=8, input_hw=(32, 32))


def _crops(rng):
    dm = rng.uniform(80.0, 620.0, (4, 32, 32, 1)).astype(np.float32)
    dm[:, :8] = 0.0
    return dm


@pytest.mark.parametrize("case", ["crops", "zeros", "negative", "tiny",
                                  "constant"])
def test_codec_bit_equal_to_jax(case):
    rng = np.random.default_rng(0)
    dm = {"crops": _crops(rng),
          "zeros": np.zeros((2, 4, 4, 1), np.float32),
          "negative": np.array([-5.0, 100.0, 0.0, 3.5],
                               np.float32).reshape(1, 2, 2, 1),
          "tiny": rng.uniform(0, 1e-7, (1, 3, 3, 1)).astype(np.float32),
          "constant": np.full((1, 2, 3, 1), 437.25, np.float32)}[case]
    q, scale = wire.encode_dm_u16(dm)
    jq, jscale = jwire.encode_dm_u16(dm)
    assert q.dtype == jq.dtype == np.uint16 and scale.shape == jscale.shape
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(scale, jscale)
    out = wire.decode_dm_u16(q, scale)
    np.testing.assert_array_equal(out, np.asarray(jwire.decode_dm_u16(q,
                                                                      scale)))
    t = wire.decode_dm_u16(torch.from_numpy(q), torch.from_numpy(scale))
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), out)
    if case == "crops":
        np.testing.assert_array_equal(out[:, :8], 0.0)
        assert np.abs(out - dm).max() <= wire.error_bound(dm.max())


def test_wire_dtype_validation(tmp_path):
    spec = synthetic.make_spec("training", directory=str(tmp_path),
                               num_shards=1, samples_per_shard=4)
    with pytest.raises(ValueError, match="requires host_preprocess"):
        InputPipeline(spec, 2, wire_dtype="uint16", device="cpu")
    with pytest.raises(ValueError, match="requires host_preprocess"):
        FramePipeline(spec, 2, wire_dtype="uint16", device="cpu")
    with pytest.raises(ValueError, match="wire_dtype"):
        FramePipeline(spec, 2, host_preprocess=True, wire_dtype="float16",
                     device="cpu")
    with pytest.raises(ValueError, match="requires host_preprocess"):
        train(spec, NET, TrainConfig(batch_size=2, sub_batch=1,
                                     wire_dtype="uint16",
                                     base_dir=str(tmp_path / "run")),
              max_steps=1, device="cpu", log_fn=quiet)
    assert wire.WIRE_DTYPES == jwire.WIRE_DTYPES


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return synthetic.make_spec("training",
                               directory=str(tmp_path_factory.mktemp("s")),
                               num_shards=2, samples_per_shard=8)


def _assert_like_device_crop(got, want, wire_dtype):
    assert got["dm"].dtype == torch.float32
    if wire_dtype == "float32":
        assert torch.equal(got["dm"], want["dm"])
    else:
        bound = wire.error_bound(float(want["dm"].max()))
        assert float((got["dm"] - want["dm"]).abs().max()) <= bound
        assert torch.equal(got["dm"] == 0, want["dm"] == 0)
    for k in ("pose", "cfg"):
        assert torch.equal(got[k], want[k]), k
    np.testing.assert_allclose(got["com"].numpy(), want["com"].numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("wire_dtype", ["float32", "uint16"])
def test_input_pipeline_host_preprocess(spec, wire_dtype):
    out = {}
    for host in (False, True):
        pipe = InputPipeline(spec, 2, 2, (32, 32), seed=7,
                             host_preprocess=host,
                             wire_dtype=wire_dtype if host else "float32",
                             device="cpu")
        try:
            it = iter(pipe)
            out[host] = [next(it) for _ in range(3)]
        finally:
            pipe.close()
    for got, want in zip(out[True], out[False]):
        assert got["dm"].shape == (2, 2, 32, 32, 1)
        _assert_like_device_crop(got, want, wire_dtype)


@pytest.mark.parametrize("wire_dtype", ["float32", "uint16"])
def test_test_pipeline_host_preprocess(spec, wire_dtype):
    want = list(FramePipeline(spec, 6, (32, 32), device="cpu"))
    got = list(FramePipeline(spec, 6, (32, 32), host_preprocess=True,
                            wire_dtype=wire_dtype, device="cpu"))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["name"] == w["name"]
        _assert_like_device_crop(g, w, wire_dtype)


def test_train_and_test_with_host_preprocess(spec, tmp_path):
    """``train()`` on the uint16 wire runs and logs finite losses;
    ``test()`` with ``EvalConfig.host_preprocess`` writes the device-crop
    run's result lines, exactly in float32 and within 0.05 mm on the uint16
    wire (the JAX package's budget for the wire, ``tests/test_wire.py``:
    the decoded depth is the candidates' z, and the net moves with it)."""
    tcfg = TrainConfig(batch_size=2, sub_batch=2, host_preprocess=True,
                       wire_dtype="uint16", summary_every=1,
                       base_dir=str(tmp_path / "train"))
    state = train(spec, NET, tcfg, max_steps=2, device="cpu", debug_level=0,
                  log_fn=quiet)
    assert state.step == 2
    payload = str(tmp_path / "p.msgpack")
    save_converted({**init_variables(NET, seed=3), "renorm_t": 0.0}, payload)
    test_spec = synthetic.make_spec("testing", directory=spec.directory,
                                    num_shards=1, samples_per_shard=10)
    results = {}
    for wire_cfg in ((False, "float32"), (True, "float32"), (True, "uint16")):
        base = str(tmp_path / "_".join(map(str, wire_cfg)))
        ecfg = EvalConfig(batch_size=4, host_preprocess=wire_cfg[0],
                          wire_dtype=wire_cfg[1])
        report = run_test(test_spec, NET, TrainConfig(base_dir=base), ecfg,
                          init_params=payload, device="cpu", log_fn=quiet)
        assert report["num_frames"] == 10
        run = os.path.join(base, os.listdir(base)[0])
        (path,) = [os.path.join(run, f) for f in os.listdir(run)
                   if f.endswith("-result.txt")]
        results[wire_cfg] = read_result_file(path)
    names, want = results[(False, "float32")]
    for key in ((True, "float32"), (True, "uint16")):
        got_names, got = results[key]
        assert got_names == names
        if key[1] == "float32":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=0.05)
