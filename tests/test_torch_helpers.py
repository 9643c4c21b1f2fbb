"""The JAX package's last public helpers against their counterparts in the
port, on the same seeded numpy inputs (the JAX functions run op by op, as
the JAX package's own tests call them):

- ``config.PCA_NORM_RATIO``, ``config.MAXIMUM_DEPTH``: equal;
- ``preprocess.area_resize``: within n - 1 float32 ulps for a box of n
  pixels (a mean of positive values summed in another order);
  ``resize_bilinear``: within 1 ulp (the same three
  interpolation steps); ``resize_nearest``: equal (an index pick);
- ``targets.um_z_component``: equal; ``gaussian_heatmaps``: within 2 ulps
  (``exp`` of XLA against torch's), on grids where no value is subnormal;
- ``decode.generate_candidates``, ``mean_shift`` (unweighted),
  ``uvd_argmax``: the decode's 2e-4 normalized bound (``PARITY.md``), the
  indices equal;
- ``augment.augment_one``: the angle and ratio fixed from numpy in both
  packages, pixels equal except where the source coordinate lies within
  1e-4 of a .5 boundary (``tests/test_torch_augment.py``), the pose within
  1e-3 mm;
- ``utils.profiling.trace_context``: a no-op without a logdir in both, and
  the port's Chrome trace holds the block's operators.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from densereg_tpu import augment as jaug  # noqa: E402
from densereg_tpu import config as jconfig  # noqa: E402
from densereg_tpu import decode as jdecode  # noqa: E402
from densereg_tpu import geometry as jgeometry  # noqa: E402
from densereg_tpu import preprocess as jpre  # noqa: E402
from densereg_tpu import targets as jtargets  # noqa: E402
from densereg_tpu.utils import profiling as jprofiling  # noqa: E402

from densereg_torch import augment, config, decode, preprocess  # noqa: E402
from densereg_torch import targets  # noqa: E402
from densereg_torch.ops import fused_decode  # noqa: E402
from densereg_torch.utils import profiling  # noqa: E402
from test_torch_augment import _boundary_pixels  # noqa: E402
from test_torch_augment import scene as augment_scene  # noqa: E402

DECODE_TOL = 2e-4     # normalized units (PARITY.md, decode row)


def ulps(a, b) -> int:
    """The largest distance in float32 units in the last place."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2 ** 31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2 ** 31) - ib, ib)
    return int(np.abs(ia - ib).max())


def test_constants_match_jax():
    assert config.PCA_NORM_RATIO == jconfig.PCA_NORM_RATIO
    assert config.MAXIMUM_DEPTH == jconfig.MAXIMUM_DEPTH
    from densereg_tpu.ops import fused_decode as jfused

    assert (fused_decode.GRID, fused_decode.NUM_CELLS) == (
        jfused.GRID, jfused.NUM_CELLS)


@pytest.mark.parametrize("shape,out", [((2, 32, 32, 1), (8, 8)),
                                       ((3, 24, 48, 3), (6, 16)),
                                       ((64, 64, 2), (16, 32))])
def test_resizes_match_jax(shape, out):
    x = np.random.default_rng(sum(shape)).uniform(
        0, 600, shape).astype(np.float32)
    t = torch.from_numpy(x)
    box = (shape[-3] // out[0]) * (shape[-2] // out[1])
    assert ulps(preprocess.area_resize(t, *out),
                jpre.area_resize(jnp.asarray(x), *out)) <= box - 1
    for size in (out, (shape[-3] * 3 // 2, shape[-2] + 5)):
        got = preprocess.resize_bilinear(t, *size)
        want = np.asarray(jpre.resize_bilinear(jnp.asarray(x), *size))
        assert got.shape == want.shape and ulps(got, want) <= 1
        np.testing.assert_array_equal(
            preprocess.resize_nearest(t, *size),
            jpre.resize_nearest(jnp.asarray(x), *size))
    with pytest.raises(ValueError, match="integer ratio"):
        preprocess.area_resize(t, shape[-3] - 1, out[1])


@pytest.mark.parametrize("hw,sigma", [(16, 3.0), (32, 5.0)])
def test_target_helpers_match_jax(hw, sigma):
    rng = np.random.default_rng(hw)
    ums = rng.uniform(-1, 1, (2, 8, 8, 3 * 14)).astype(np.float32)
    np.testing.assert_array_equal(
        targets.um_z_component(torch.from_numpy(ums)),
        jtargets.um_z_component(jnp.asarray(ums)))
    for uvd in (rng.uniform(-3, hw + 3, (2, 3 * 16)),
                rng.uniform(-3, hw + 3, (2, 5, 21, 3))):
        uvd = uvd.astype(np.float32)
        got = targets.gaussian_heatmaps(torch.from_numpy(uvd), hw, hw, sigma)
        want = np.asarray(jtargets.gaussian_heatmaps(jnp.asarray(uvd), hw,
                                                     hw, sigma))
        assert got.shape == want.shape
        assert want.min() > np.finfo(np.float32).tiny     # no subnormal
        assert ulps(got, want) <= 2
        assert want.max() == pytest.approx(1.0, abs=0.2)


def test_decode_helpers_match_jax():
    rng = np.random.default_rng(3)
    b, h, w, j, n = 3, 16, 16, 14, 5
    refined = rng.uniform(-0.5, 2, (b, h, w, j)).astype(np.float32)
    cand = rng.uniform(-1, 1, (b, h, w, 3 * j)).astype(np.float32)
    scores, cans, idx = decode.generate_candidates(
        torch.from_numpy(refined), torch.from_numpy(cand), n)
    jscores, jcans, jidx = (np.asarray(v) for v in jdecode.generate_candidates(
        jnp.asarray(refined), jnp.asarray(cand), n))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(scores.numpy(), jscores)
    assert cans.shape == (b, j, n, 3)
    np.testing.assert_allclose(cans.numpy(), jcans, atol=DECODE_TOL, rtol=0)

    # the unweighted mean shift: clustered candidates with outliers
    centre = rng.uniform(-0.6, 0.6, (b, j, 1, 3))
    pts = centre + rng.normal(0, 0.15, (b, j, 12, 3))
    pts[..., :2, :] = rng.uniform(-1, 1, (b, j, 2, 3))
    pts = pts.astype(np.float32)
    for num_it, band in ((10, 0.8), (4, 0.4)):
        got = decode.mean_shift(torch.from_numpy(pts), num_it, band)
        want = np.asarray(jdecode.mean_shift(jnp.asarray(pts), num_it, band))
        np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                                   rtol=0)
    np.testing.assert_allclose(decode.mean_shift(torch.from_numpy(pts)),
                               jdecode.mean_shift(jnp.asarray(pts)),
                               atol=DECODE_TOL, rtol=0)

    hms = rng.uniform(0, 1, (b, h, w, j)).astype(np.float32)
    hms[0, 3, 4, 2] = hms[0, 9, 1, 2] = 2.0           # a tie: the first wins
    ds = rng.uniform(-1, 1, (b, h, w, j)).astype(np.float32)
    got = decode.uvd_argmax(torch.from_numpy(hms), torch.from_numpy(ds))
    want = np.asarray(jdecode.uvd_argmax(jnp.asarray(hms), jnp.asarray(ds)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(want.reshape(b, j, 3)[0, 2, :2]) == (4.0, 3.0)


def test_augment_one_matches_jax(monkeypatch):
    dms, poses, cfgs, coms, angle, ratio = augment_scene(3, 32, seed=9)
    for i in range(len(dms)):
        a, r = angle[i], ratio[i]
        monkeypatch.setattr(jaug, "_affine_params", lambda key: (a, r))
        monkeypatch.setattr(
            augment, "_affine_params",
            lambda n, generator=None, device=None: (
                torch.from_numpy(a[None]), torch.from_numpy(r[None])))
        jdm, jpose = jaug.augment_one(jax.random.key(0), dms[i], poses[i],
                                      cfgs[i], coms[i])
        dm, pose = augment.augment_one(
            torch.Generator(), *(torch.from_numpy(v[i]) for v in
                                 (dms, poses, cfgs, coms)))
        assert dm.shape == dms[i].shape and pose.shape == poses[i].shape
        uv_com = np.asarray(jgeometry.xyz2uvd(coms[i], cfgs[i]))[:2]
        bad = (dm.numpy() != np.asarray(jdm))[..., 0]
        assert not (bad & ~_boundary_pixels(32, a, r, uv_com)).any()
        np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-3)
        assert np.abs(pose.numpy() - poses[i]).max() > 1.0


def test_augment_one_draws_from_the_generator():
    dms, poses, cfgs, coms, _, _ = augment_scene(1, 32, seed=2)
    args = [torch.from_numpy(v[0]) for v in (dms, poses, cfgs, coms)]
    runs = [augment.augment_one(torch.Generator().manual_seed(s), *args)
            for s in (5, 5, 6)]
    assert torch.equal(runs[0][1], runs[1][1])
    assert not torch.equal(runs[0][1], runs[2][1])


def test_trace_context(tmp_path):
    for ctx in (profiling.trace_context(None), profiling.trace_context(""),
                jprofiling.trace_context(None)):
        with ctx:
            pass
    assert not os.listdir(tmp_path)
    logdir = tmp_path / "trace"
    with profiling.trace_context(str(logdir)):
        torch.ones(8, 8) @ torch.ones(8, 8)
    (path,) = list(logdir.iterdir())
    assert path.name.startswith("trace_") and path.suffix == ".json"
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names
