"""The port's augmentation against ``densereg_tpu/augment.py``, with the
angle and the ratio fixed from numpy.

The warp is held to the JAX package's gather form (the oracle) and to its
one-hot matmul form pixel for pixel. ``sin``/``cos`` of XLA's CPU backend
and of torch may differ by an ulp, which moves a source coordinate lying on
a .5 boundary to the other pixel: a mismatch is allowed only at pixels
whose source coordinate (in float64) lies within 1e-4 of such a boundary,
and they are counted. Poses: atol 1e-3 mm.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from densereg_tpu import augment as jaug  # noqa: E402
from densereg_tpu import geometry as jgeometry  # noqa: E402

from densereg_torch import augment  # noqa: E402

ICVL = np.array([241.42, 241.42, 160.0, 120.0, 320.0, 240.0], np.float32)


def scene(b: int, hw: int, seed: int):
    """Raw-mm crops with a background, poses, crop intrinsics, centers of
    mass, and the fixed per-frame angles and (height, width) ratios."""
    rng = np.random.default_rng(seed)
    s = hw / ICVL[4], hw / ICVL[5]
    cfg = np.array([ICVL[0] * s[0], ICVL[1] * s[1], ICVL[2] * s[0],
                    ICVL[3] * s[1], hw, hw], np.float32)
    dms = rng.uniform(300, 500, (b, hw, hw, 1)).astype(np.float32)
    dms[rng.random(dms.shape) < 0.3] = 0.0
    poses = np.stack([rng.uniform(-40, 40, (b, 16)),
                      rng.uniform(-40, 40, (b, 16)),
                      rng.uniform(360, 440, (b, 16))], -1).astype(np.float32)
    coms = np.stack([rng.uniform(-10, 10, b), rng.uniform(-10, 10, b),
                     rng.uniform(380, 420, b)], -1).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, b).astype(np.float32)
    ratio = rng.uniform(0.9, 1.1, (b, 2)).astype(np.float32)
    return (dms, poses.reshape(b, -1), np.tile(cfg, (b, 1)), coms, angle,
            ratio)


def _boundary_pixels(hw, angle, ratio, center):
    """Pixels whose inverse-mapped source coordinate lies within 1e-4 of a
    .5 boundary, by the JAX formula in float64."""
    q = np.arange(hw, dtype=np.float64)
    qx = q[None, :] - center[0]
    qy = q[:, None] - center[1]
    ux, uy = qx / ratio[1], qy / ratio[0]
    c, s = np.cos(angle), np.sin(angle)
    near = lambda v: np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-4
    return near(ux * c - uy * s + center[0]) | near(ux * s + uy * c
                                                    + center[1])


@pytest.mark.parametrize("hw", [32, 128])
def test_warp_matches_gather_and_matmul_forms(hw):
    dms, poses, cfgs, coms, angle, ratio = scene(4, hw, seed=hw)
    uv_com = np.array(jgeometry.xyz2uvd(coms, cfgs))[:, :2]
    got = augment.warp_image(*(torch.from_numpy(a) for a in
                               (dms, angle, ratio, uv_com))).numpy()
    allowed = 0
    for i in range(len(dms)):
        want = np.asarray(jaug._warp_image_gather(dms[i], angle[i], ratio[i],
                                                  uv_com[i]))
        mm = np.asarray(jaug._warp_image(dms[i], angle[i], ratio[i],
                                         uv_com[i]))
        np.testing.assert_array_equal(mm, want)
        edge = _boundary_pixels(hw, angle[i], ratio[i], uv_com[i])
        bad = (got[i] != want)[..., 0]
        assert not (bad & ~edge).any(), np.argwhere(bad & ~edge)[:5]
        allowed += int(bad.sum())
    assert allowed <= 4, allowed           # counted: rare ulp flips
    assert (got != 0).mean() > 0.3         # most of the crop survives


def test_pose_transform_matches_jax():
    dms, poses, cfgs, coms, angle, ratio = scene(5, 32, seed=3)

    def jax_pose(pose, cfg, com, a, r):      # augment_one's pose half
        uv_com = jgeometry.xyz2uvd(com, cfg)[:2]
        uvd = jgeometry.xyz2uvd(pose, cfg).reshape(-1, 3)
        uv = jaug._transform_pose_uv(uvd[:, :2], a, r, uv_com)
        return jgeometry.uvd2xyz(
            jnp.concatenate([uv, uvd[:, 2:3]], -1).reshape(-1), cfg)

    want = np.asarray(jax.vmap(jax_pose)(poses, cfgs, coms, angle, ratio))
    _, got = augment.augment_with(*(torch.from_numpy(a) for a in
                                    (dms, poses, cfgs, coms, angle, ratio)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert np.abs(want - poses).max() > 1.0          # the pose did move
    # depth is kept: only u and v move
    np.testing.assert_allclose(got.numpy().reshape(5, -1, 3)[..., 2],
                               poses.reshape(5, -1, 3)[..., 2], atol=1e-4)


def test_augment_batch_is_seeded():
    dms, poses, cfgs, coms, _, _ = scene(6, 32, seed=4)
    args = [torch.from_numpy(a) for a in (dms, poses, cfgs, coms)]
    run = lambda s: augment.augment_batch(
        *args, generator=torch.Generator().manual_seed(s))
    (d1, p1), (d2, p2), (d3, p3) = run(7), run(7), run(8)
    assert torch.equal(d1, d2) and torch.equal(p1, p2)
    assert not torch.equal(p1, p3)
    assert d1.shape == args[0].shape and p1.shape == args[1].shape


def test_affine_parameter_distributions():
    angle, ratio = augment._affine_params(
        20000, torch.Generator().manual_seed(0))
    assert angle.shape == (20000,) and ratio.shape == (20000, 2)
    assert -np.pi <= angle.min() and angle.max() <= np.pi
    assert abs(angle.mean().item()) < 0.05
    assert abs(angle.std().item() - 2 * np.pi / np.sqrt(12)) < 0.03
    assert ratio.min().item() == pytest.approx(0.9)
    assert ratio.max().item() == pytest.approx(1.1)
    # N(1, 0.2) clipped to [0.9, 1.1]: P(|z| > 0.5) = 0.617 at each end
    at_edge = ((ratio <= 0.9 + 1e-7) | (ratio >= 1.1 - 1e-7)).float().mean()
    assert abs(at_edge.item() - 0.617) < 0.02
    # the JAX package's draw has the same ranges
    ja, jr = jaug._affine_params(jax.random.key(0))
    assert -np.pi <= float(ja) <= np.pi and (0.9 <= np.asarray(jr)).all()
