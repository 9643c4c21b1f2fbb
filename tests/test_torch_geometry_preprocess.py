"""densereg_torch.geometry / preprocess against the JAX package on the same
numpy inputs.

Tolerances (PARITY.md): geometry 1e-5 relative; the crop 1e-2 mm absolute
or 1e-4 relative on the cropped depth (the post-crop intrinsics to float32
rounding); center of mass and norm_dm 1e-6 relative (the mean depth is a
sum of thousands of pixels, added in another order); method2_resize exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402

from densereg_tpu import geometry as jgeo  # noqa: E402
from densereg_tpu import preprocess as jpre  # noqa: E402

from densereg_torch import geometry, preprocess  # noqa: E402
from densereg_torch.config import CameraConfig  # noqa: E402

ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
T = torch.from_numpy


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_geometry_matches_jax(rng):
    b, j = 3, 16
    xyz = np.stack([rng.uniform(-80, 80, (b, j)), rng.uniform(-80, 80, (b, j)),
                    rng.uniform(300, 500, (b, j))], -1).reshape(b, 3 * j)
    xyz = xyz.astype(np.float32)
    cfgs = np.tile(np.asarray(ICVL, np.float32), (b, 1))
    cfgs[:, 0] *= rng.uniform(0.5, 2.0, b).astype(np.float32)
    coms = rng.uniform(-50, 450, (b, 3)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)

    uvd = geometry.xyz2uvd(T(xyz), T(cfgs))
    _close(uvd, jgeo.xyz2uvd(xyz, cfgs), **tol)
    _close(geometry.uvd2xyz(uvd, T(cfgs)), jgeo.uvd2xyz(np.asarray(uvd), cfgs),
           **tol)
    _close(geometry.scale_cfg(T(cfgs), 32, 24), jgeo.scale_cfg(cfgs, 32, 24),
           **tol)
    normed = geometry.norm_xyz_pose(T(xyz), T(coms))
    _close(normed, jgeo.norm_xyz_pose(jnp.asarray(xyz), jnp.asarray(coms)),
           **tol)
    _close(geometry.unnorm_xyz_pose(normed, T(coms)), xyz, **tol)

    dm = rng.uniform(-0.2, 1.0, (b, 32, 32, 1)).astype(np.float32)
    dm[rng.random(dm.shape) < 0.2] = -1.0      # background -> far plane
    _close(geometry.backproject_dm(T(dm), T(cfgs), T(coms)),
           jgeo.backproject_dm(dm, cfgs, coms), **tol)


# (top, left, bottom, right, depth threshold): square, tall, wide, touching
# the frame's corners, and a box running past the frame's right edge
BOXES = np.array([[60, 80, 200, 220, 600],
                  [10, 100, 230, 180, 470],
                  [90.7, 0, 150.2, 319.9, 520],
                  [0, 0, 120, 96, 600],
                  [150, 250, 240, 340, 600]], np.float32)


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("out_hw", [128, 64])
def test_crop_com_norm_match_jax(rng, dtype, out_hw):
    b = len(BOXES)
    frames = np.round(rng.uniform(300, 700, (b, 240, 320, 1))).astype(dtype)
    frames[:, :, :40] = 0                          # invalid strip
    poses = np.zeros((b, 3), np.float32)
    want_dm, _, want_cfg, want_com = jpre.preprocess_batch_from_bbx(
        jnp.asarray(frames), poses, BOXES, np.asarray(ICVL, np.float32),
        out_hw, out_hw)

    dms, cfgs = preprocess.crop_from_bbx(T(frames), T(BOXES), ICVL.as_array(),
                                         out_hw, out_hw)
    assert dms.shape == (b, out_hw, out_hw, 1) and dms.dtype == torch.float32
    _close(dms, want_dm, atol=1e-2, rtol=1e-4)
    _close(cfgs, want_cfg, rtol=1e-6)

    coms = preprocess.center_of_mass(dms, cfgs)
    _close(coms, want_com, rtol=1e-6, atol=1e-6)
    _close(preprocess.norm_dm(dms, coms),
           jpre.norm_dm(jnp.asarray(want_dm), jnp.asarray(want_com)),
           rtol=1e-6, atol=1e-6)

    tiny = preprocess.method2_resize(T(np.array(want_dm)), out_hw // 4,
                                     out_hw // 4)
    np.testing.assert_array_equal(
        tiny.numpy(), np.asarray(jpre.method2_resize(want_dm, out_hw // 4,
                                                     out_hw // 4)))


def test_center_of_mass_all_invalid_floors_at_200mm():
    cfgs = torch.tensor([[300.0, 300.0, 64.0, 60.0, 128.0, 128.0]])
    com = preprocess.center_of_mass(torch.zeros((1, 128, 128, 1)), cfgs)
    want = jpre.center_of_mass(jnp.zeros((128, 128, 1)), cfgs[0].numpy())
    _close(com[0], want, rtol=1e-6)
    assert com[0, 2].item() == 200.0


def test_method2_resize_rejects_fractional_ratio():
    with pytest.raises(ValueError, match="integer ratio"):
        preprocess.method2_resize(torch.zeros((1, 30, 30, 1)), 8, 8)
