"""The port's export artifacts on the CPU (``densereg_torch/export.py``) and
the kernels as ``torch.library`` custom ops.

A loaded artifact runs the same ops in the same order as the live
``Predictor`` on the same weights, so the round trips are held bit for bit
(float32, the uint16 entry, a bucket ladder (1, 4, max), calibrated int8).
Against the JAX package's artifact of the same seeded weights the bound is
the serving tests' 0.02 mm (``tests/test_torch_serving.py``, PARITY.md):
the two frameworks sum the convolutions in other orders.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch.export import (  # noqa: E402
    ExportedPredictor,
    export_predictor,
    load_exported,
    read_artifact,
)
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.ops import OP_NAMES  # noqa: E402
from densereg_torch.ops.int8_dwconv import pack_dw_weight  # noqa: E402
from densereg_torch.ops.int8_gemm import pack_weight  # noqa: E402
from densereg_torch.ops.int8_layout import quantize  # noqa: E402
from densereg_torch.serve import Client, Server  # noqa: E402

from test_torch_serving import _hand_frames  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = dict(num_stack=1, num_fea=8, num_joint=14, input_hw=(32, 32))
ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
MAX_BATCH = 8
LADDER = (1, 4)
XYZ_ATOL_MM = 0.02
# blob order of a u16 artifact with the ladder: max_batch first
BLOBS = [f"cpu/b{b}/{dt}" for b in (MAX_BATCH,) + LADDER
         for dt in ("f32", "u16")]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    variables = init_variables(NetConfig(**SHAPE), seed=11)
    frames, bbxs = _hand_frames(np.random.default_rng(2), 10)
    live = Predictor(variables, NetConfig(**SHAPE), ICVL,
                     max_batch=MAX_BATCH, batch_buckets=LADDER, device="cpu")
    path = str(tmp_path_factory.mktemp("export") / "f32.pt2")
    export_predictor(live, path)
    return variables, frames, bbxs, live, path


@pytest.fixture(scope="module")
def loaded(setup):
    return load_exported(setup[4])


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_round_trip_equals_live_predictor(setup, loaded, dtype):
    """Every bucket of the ladder and both entries, bit for bit: 10 frames
    (chunks of 8 and 2, the second padded to bucket 4), a lone frame
    (bucket 1)."""
    _, frames, bbxs, live, _ = setup
    frames = frames.astype(dtype)
    assert loaded.batch_buckets == (1, 4, MAX_BATCH) and loaded.accepts_u16
    assert (loaded.max_batch, loaded.num_joint) == (MAX_BATCH, 14)
    assert loaded.frame_hw == (240, 320)
    np.testing.assert_array_equal(loaded.camera, np.asarray(
        ICVL.as_array(), np.float32))
    got = loaded(frames, bbxs)
    assert got.shape == (10, 42) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, live(frames, bbxs))
    np.testing.assert_array_equal(loaded(frames[:1], bbxs[:1]),
                                  live(frames[:1], bbxs[:1]))
    for b, bucket in ((1, 1), (3, 4), (5, 8)):
        assert loaded._dispatch(frames[:b, ..., None],
                                bbxs[:b]).shape == (bucket, 42)
    loaded.warmup()


def test_int8_calibrated_round_trip(setup, tmp_path):
    """The calibrated int8 predictor (K3's two entries as ops) exports and
    loads to the live predictor's numbers."""
    variables, frames, bbxs, _, _ = setup
    live = Predictor(variables, NetConfig(**SHAPE), ICVL, max_batch=4,
                     quantize=True, calibration=(frames, bbxs), device="cpu")
    path = str(tmp_path / "int8.pt2")
    export_predictor(live, path, u16=False)
    header, blobs = read_artifact(path)
    assert header["quantized"] and [b[:3] for b in blobs] == [
        ("cpu", 4, "f32")]
    loaded = load_exported(path)
    assert not loaded.accepts_u16
    np.testing.assert_array_equal(loaded(frames, bbxs), live(frames, bbxs))
    # a u16 request to an f32-only artifact is cast on the host
    np.testing.assert_array_equal(loaded(frames.astype(np.uint16), bbxs),
                                  live(frames, bbxs))


@pytest.fixture(scope="module")
def dynamic(setup, tmp_path_factory):
    """A dynamic int8 predictor (each batch scales by its own maxima) and
    its one-program artifact."""
    variables = setup[0]
    live = Predictor(variables, NetConfig(**SHAPE), ICVL, max_batch=4,
                     quantize=True, device="cpu")
    path = str(tmp_path_factory.mktemp("export") / "dynamic.pt2")
    export_predictor(live, path, u16=False)
    return live, path


def test_bfloat16_and_dynamic_int8_round_trip(setup, dynamic, tmp_path):
    """bfloat16 and dynamic int8 export too, one float32 entry each, to the
    live predictor's numbers."""
    variables, frames, bbxs, _, _ = setup
    live = Predictor(variables, NetConfig(**SHAPE, compute_dtype="bfloat16"),
                     ICVL, max_batch=4, device="cpu")
    path = str(tmp_path / "bf16.pt2")
    export_predictor(live, path, u16=False)
    for live, path in ((live, path), dynamic):
        np.testing.assert_array_equal(load_exported(path)(frames, bbxs),
                                      live(frames, bbxs))


def test_matches_the_jax_artifact(setup, loaded, tmp_path):
    """The port's loaded artifact against the JAX package's loaded artifact
    of the same seeded weights."""
    from densereg_tpu import config as jconfig
    from densereg_tpu.export import export_predictor as jexport
    from densereg_tpu.export import load_exported as jload
    from densereg_tpu.serving import Predictor as JPredictor

    variables, frames, bbxs, _, _ = setup
    theirs = JPredictor(variables, jconfig.NetConfig(**SHAPE),
                        jconfig.CameraConfig(*ICVL), max_batch=4)
    path = str(tmp_path / "jax.bin")
    jexport(theirs, path, platforms=("cpu",), u16=False)
    want = jload(path)(frames, bbxs)
    err = np.abs(loaded(frames, bbxs) - want).max(axis=-1)
    assert (err <= XYZ_ATOL_MM).all(), (
        f"frames {np.flatnonzero(err > XYZ_ATOL_MM).tolist()} differ by up "
        f"to {err.max():.4f} mm")
    # neither package takes the other's artifact for its own
    with pytest.raises(ValueError, match="not a densereg_torch"):
        load_exported(path)
    with pytest.raises(ValueError, match="not a densereg export"):
        jload(setup[4])


@pytest.mark.parametrize("blob", range(len(BLOBS)), ids=BLOBS)
def test_a_flipped_byte_in_any_blob_raises(setup, tmp_path, blob):
    path = setup[4]
    header, blobs = read_artifact(path)
    assert [f"{p}/b{b}/{dt}" for p, b, dt, _ in blobs] == BLOBS
    raw = bytearray(open(path, "rb").read())
    start = len(raw) - sum(len(d) for *_, d in blobs)
    start += sum(len(d) for *_, d in blobs[:blob])
    raw[start + len(blobs[blob][3]) // 2] ^= 0x01
    bad = tmp_path / "bad.pt2"
    bad.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match=f"{BLOBS[blob]} blob corrupted"):
        load_exported(str(bad))


def test_loading_needs_no_model_code(dynamic):
    """A fresh process loads and runs an int8 artifact (K1 and K3's ops)
    with no module of ``densereg_torch.models`` imported."""
    code = (
        "import sys, numpy as np\n"
        "from densereg_torch.export import load_exported\n"
        f"p = load_exported({dynamic[1]!r})\n"
        "x = p(np.full((2, 240, 320), 400.0, np.float32),\n"
        "      np.asarray([[60, 100, 180, 220, 520.0]] * 2, np.float32))\n"
        "assert x.shape == (2, 42) and np.isfinite(x).all()\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.startswith(('densereg_torch.models',\n"
        "                              'densereg_torch.serving', 'jax',\n"
        "                              'densereg_tpu')))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_server_serves_an_exported_predictor(setup, loaded, tmp_path):
    _, frames, bbxs, _, _ = setup
    assert isinstance(loaded, ExportedPredictor)
    with Server(loaded, str(tmp_path / "e.sock"), window_ms=20) as srv:
        with Client(srv.address) as c:
            got = c.predict_batch(frames[:5], bbxs[:5])
            st = c.stats()
    np.testing.assert_array_equal(got, loaded(frames[:5], bbxs[:5]))
    assert st["frame_hw"] == [240, 320] and st["max_batch"] == MAX_BATCH


def _op_cases():
    """Small CPU inputs for every custom op (each output layout the int8
    entries can give)."""
    g = torch.Generator().manual_seed(0)
    f32 = lambda *s: torch.rand(*s, generator=g)
    i8 = lambda *s: torch.randint(-127, 128, s, generator=g,
                                  dtype=torch.int8)
    b, h, w, j = 2, 8, 8, 3
    hms, hm3s = f32(b, h, w, j), f32(b, h, w, j)
    ums = f32(b, h, w, 3 * j) * 2 - 1
    tiny = f32(b, h, w, 1) * 2 - 1
    cfgs = torch.tensor([[30.0, 30.0, 4.0, 4.0, 8.0, 8.0]] * b)
    coms = torch.tensor([[0.0, 0.0, 400.0]] * b)
    scale, bias, s_y = f32(24) * 1e-3, f32(24), torch.tensor(0.5)
    x4 = quantize(f32(2, 6, 6, 20), torch.tensor(0.01), pitch16=True)
    wk = pack_weight(i8(3, 3, 20, 24))
    wdw = pack_dw_weight(i8(3, 3, 1, 20))
    cases = [("fused_decode", (hms, hm3s, ums, tiny, cfgs, coms, 5, 10,
                               0.4, 4)),
             ("weighted_mean_shift", (f32(b, j, 5, 3), f32(b, j, 5), 10,
                                      0.4, 4))]
    for emit_q, emit_f in ((True, False), (False, True), (True, True)):
        kw = (s_y if emit_q else None, True, emit_q, emit_f, torch.bfloat16)
        cases += [
            ("int8_gemm_requant", (i8(10, 20), i8(20, 24), scale, bias)
             + kw),
            ("int8_conv_requant", (x4, wk, 3, 2, scale, bias) + kw),
            ("int8_dwconv_requant", (x4, wdw, 3, scale[:20], bias[:20])
             + kw)]
    amax = torch.tensor(0.7)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (f32(2, 3, 3, 20).to(dtype) for _ in range(2))
        cases += [("int8_quantize", (a, None, amax)),
                  ("int8_quantize", (a, b, amax))]
    return cases


@pytest.mark.parametrize("name,args", _op_cases(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_op_fake_agrees_with_cpu(name, args):
    """``torch.library.opcheck`` on the CPU implementation (schema, the
    fake's shapes, dtypes and strides against the real outputs, tracing),
    and the strides once more by hand."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = getattr(torch.ops.densereg, name).default
    torch.library.opcheck(op, args)
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.stride()) == (f.shape, f.dtype,
                                                  f.stride())


def test_every_kernel_is_an_op():
    assert OP_NAMES == ("fused_decode", "weighted_mean_shift",
                        "int8_gemm_requant", "int8_conv_requant",
                        "int8_dwconv_requant", "int8_quantize")
    for name in OP_NAMES:
        op = getattr(torch.ops.densereg, name).default
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            op.name(), "CUDA"), name
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            op.name(), "CPU"), name


def test_cuda_export_needs_a_card(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal cannot show")
    with pytest.raises(RuntimeError, match="needs a card"):
        export_predictor(setup[3], str(tmp_path / "x.pt2"),
                         platforms=("cuda",))
