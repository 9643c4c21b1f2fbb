"""The port's Predictor and make_infer_fn on the CPU against the JAX
package's, on the same weights and requests: s2/f16/J14 at 64 input, float32
and uint16 frames, a request larger than max_batch (chunk loop) and a
batch-bucket ladder.

Tolerances: heads 1e-4 per element (PARITY.md, network row). xyz 0.02 mm,
which is the decode's 2e-4 normalized bound (PARITY.md, decode row) times
POSE_NORM_RATIO: the heads differ by about 1e-6 relative (convolutions sum
in another order), which moves the candidates and the mean shift far less
than that. A near-tie in the top-k scores could still flip one candidate
between the packages; the test then reports the two scores so that the
tie shows, rather than widening the bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402

from densereg_tpu import config as jconfig  # noqa: E402
from densereg_tpu.eval.loop import make_infer_fn as jmake_infer  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402
from densereg_tpu.preprocess import (  # noqa: E402
    norm_dm as jnorm_dm,
    preprocess_batch_from_bbx,
)
from densereg_tpu.serving import Predictor as JPredictor  # noqa: E402

from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch import host_loop  # noqa: E402
from densereg_torch.eval import make_infer_fn  # noqa: E402
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.ops.fused_decode import fused_decode  # noqa: E402
from densereg_torch.preprocess import (  # noqa: E402
    center_of_mass,
    crop_from_bbx,
    norm_dm,
)

SHAPE = dict(num_stack=2, num_fea=16, num_joint=14, input_hw=(64, 64))
ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
XYZ_ATOL_MM = 0.02


def _hand_frames(rng, b):
    """uint16-valued depth frames: a noisy tilted ellipse (the hand, about
    350-450 mm) over a far background, and boxes around it."""
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    frames = np.full((b, 240, 320), 900.0, np.float32)
    bbxs = np.zeros((b, 5), np.float32)
    for i in range(b):
        cy, cx = rng.uniform(90, 150), rng.uniform(120, 200)
        ry, rx = rng.uniform(30, 60), rng.uniform(30, 60)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        surf = 400.0 + 0.5 * (yy - cy) + rng.normal(0, 3.0, yy.shape)
        frames[i] = np.where(inside, surf, frames[i])
        bbxs[i] = [cy - ry - 8, cx - rx - 5, cy + ry + 6, cx + rx + 9, 520.0]
    return np.round(frames), bbxs


@pytest.fixture(scope="module")
def setup():
    variables = init_variables(NetConfig(**SHAPE), seed=11)
    frames, bbxs = _hand_frames(np.random.default_rng(2), 6)
    ours = Predictor(variables, NetConfig(**SHAPE), ICVL, max_batch=4,
                     batch_buckets=(1,), device="cpu")
    theirs = JPredictor(variables, jconfig.NetConfig(**SHAPE),
                        jconfig.CameraConfig(*ICVL), max_batch=4,
                        batch_buckets=(1,))
    return variables, frames, bbxs, ours, theirs


def test_heads_match_jax(setup):
    """The predictors' folded nets on one normalized input. (Each package's
    own preprocess gives the same crop, but its center of mass sums some
    4,000 pixels in another order: about 1.5e-4 mm apart, 5e-7 in normalized
    depth, which the random net amplifies past 1e-4 on a few head elements.
    The preprocess is held to its own tolerance in
    test_torch_geometry_preprocess.py.)"""
    variables, frames, bbxs, ours, theirs = setup
    frames = frames[..., None].astype(np.float32)
    dms, _, cfgs, coms = preprocess_batch_from_bbx(
        jnp.asarray(frames), np.zeros((6, 3)), bbxs,
        np.asarray(ICVL, np.float32), 64, 64)
    normed = jnorm_dm(dms, coms)
    want = JNet(theirs.net_cfg).apply(theirs.variables, normed, train=False)
    t_dms, t_cfgs = crop_from_bbx(torch.from_numpy(frames),
                                  torch.from_numpy(bbxs), ours._cam, 64, 64)
    np.testing.assert_array_equal(t_dms.numpy(), np.asarray(dms))
    np.testing.assert_allclose(center_of_mass(t_dms, t_cfgs).numpy(),
                               np.asarray(coms), rtol=1e-6)
    with torch.inference_mode():
        got = ours.net(torch.from_numpy(np.array(normed)))
    for key in ("hm", "hm3", "um"):
        for g, w in zip(got[key], want[key]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                       rtol=0)


def _assert_xyz_close(got, want):
    err = np.abs(got - want).max(axis=-1)
    bad = np.flatnonzero(err > XYZ_ATOL_MM)
    assert bad.size == 0, (
        f"frames {bad.tolist()} differ by up to {err.max():.4f} mm; a flip "
        f"of a near-tied top-k candidate shows as one frame far off")


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
def test_predictor_matches_jax(setup, dtype):
    _, frames, bbxs, ours, theirs = setup
    frames = frames.astype(dtype)
    launches = fused_decode.launches
    got = ours(frames, bbxs)                  # 6 > max_batch: chunks 4 + 2
    assert fused_decode.launches == launches  # CPU: the plain decode
    assert got.shape == (6, 42) and got.dtype == np.float32
    assert np.isfinite(got).all()
    _assert_xyz_close(got, theirs(frames, bbxs))
    lone = ours(frames[:1], bbxs[:1])
    assert ours._dispatch(frames[:1, ..., None], bbxs[:1]).shape[0] == 1
    # bucket 1 against a row of bucket 4: the convolutions may pick other
    # algorithms per batch size, so the same bound as across packages
    _assert_xyz_close(lone, got[:1])


def test_three_chunk_request_counts_its_fetches(setup):
    """A 10-frame request at max_batch 4 (chunks of 4, 4 and 2, the last
    padded to bucket 4) fetches each chunk once, the first two with the
    next chunk enqueued, none ready (the CPU has no event), and equals the
    chunk loop that copied each dispatch's rows to the host by ``.cpu()``."""
    _, _, _, ours, _ = setup
    frames, bbxs = _hand_frames(np.random.default_rng(5), 10)
    before = dict(host_loop.fetch_counts)
    got = ours(frames, bbxs)
    moved = {k: host_loop.fetch_counts[k] - before[k] for k in before}
    assert moved == {"fetches": 3, "ahead": 2, "ready": 0}
    want = np.concatenate([
        ours._dispatch(frames[i:i + 4, ..., None], bbxs[i:i + 4])
        [:len(frames[i:i + 4])].cpu().numpy() for i in range(0, 10, 4)])
    np.testing.assert_array_equal(got, want)


def test_uint16_request_matches_float32(setup):
    _, frames, bbxs, ours, _ = setup
    np.testing.assert_array_equal(ours(frames.astype(np.uint16), bbxs),
                                  ours(frames.astype(np.float32), bbxs))


def test_buckets_and_unported_options(setup, tmp_path):
    variables, _, _, ours, _ = setup
    assert ours.batch_buckets == (1, 4) and ours.accepts_u16
    assert ours.net_cfg.fold_bn
    ours.warmup()
    with pytest.raises(ValueError, match="batch_buckets"):
        Predictor(variables, NetConfig(**SHAPE), ICVL, max_batch=4,
                  batch_buckets=(6,), device="cpu")
    # int8 serving is ported (tests/test_torch_int8.py), and so is mesh
    # (tests/test_torch_parallel.py): a mesh must be a parallel.Mesh
    with pytest.raises(TypeError, match="make_mesh"):
        Predictor(variables, NetConfig(**SHAPE), ICVL, device="cpu",
                  mesh=object())
    # calibration without quantize is ignored, as in the JAX package
    assert not Predictor(variables, NetConfig(**SHAPE), ICVL, device="cpu",
                         calibration=(None, None)).net_cfg.quantize
    # from_converted is ported (tests/test_torch_convert.py): a path with
    # no payload has nothing to serve
    with pytest.raises(FileNotFoundError):
        Predictor.from_converted(str(tmp_path / "none.msgpack"),
                                 NetConfig(**SHAPE), ICVL, device="cpu")
    # from_checkpoint is ported (tests/test_torch_train_loop.py): a run
    # directory without checkpoints has nothing to serve
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(str(tmp_path), NetConfig(**SHAPE), ICVL,
                                  device="cpu")


def test_make_infer_fn_matches_jax(setup):
    variables, frames, bbxs, ours, theirs = setup
    dms, _, cfgs, coms = preprocess_batch_from_bbx(
        jnp.asarray(frames[..., None].astype(np.float32)), np.zeros((6, 3)),
        bbxs, np.asarray(ICVL, np.float32), 64, 64)
    dms, cfgs, coms = (np.array(a) for a in (dms, cfgs, coms))
    want = np.asarray(jmake_infer(theirs.net_cfg)(theirs.variables, dms, cfgs,
                                                  coms))
    infer = make_infer_fn(NetConfig(**SHAPE), device="cpu")
    _assert_xyz_close(infer(ours.net, dms, cfgs, coms).numpy(), want)
    _assert_xyz_close(infer(variables, dms, cfgs, coms).numpy(), want)
