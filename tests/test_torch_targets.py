"""The port's training targets against ``densereg_tpu/targets.py`` on the
same numpy-seeded poses and crops: J = 3 and 16, heads of 8 and 32.

Tolerances: atol 1e-6 on every map; the unit offsets ``um`` atol 1e-5 (a
division by the offset magnitude), except where that magnitude ``d`` lies
within 1e-5 of the 0.79 mask edge, where one package may keep a vector the
other zeroes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402

from densereg_tpu import geometry as jgeometry  # noqa: E402
from densereg_tpu import targets as jtargets  # noqa: E402

from densereg_torch import targets  # noqa: E402
from densereg_torch.config import MAX_DIST_3D  # noqa: E402

ICVL = np.array([241.42, 241.42, 160.0, 120.0, 320.0, 240.0], np.float32)


def scene(j: int, head: int, b: int = 3, seed: int = 0):
    """Poses, crop intrinsics of a ``4 * head`` input, centers of mass and
    normalized crops (a quarter background, -1) at that input size."""
    rng = np.random.default_rng(seed + 17 * j + head)
    hw = 4 * head
    s = hw / ICVL[4], hw / ICVL[5]
    cfg = np.array([ICVL[0] * s[0], ICVL[1] * s[1], ICVL[2] * s[0],
                    ICVL[3] * s[1], hw, hw], np.float32)
    poses = np.stack([rng.uniform(-40, 40, (b, j)), rng.uniform(-40, 40, (b, j)),
                      rng.uniform(360, 440, (b, j))], -1).astype(np.float32)
    coms = poses.mean(axis=1)
    normed = rng.uniform(-0.5, 1.0, (b, hw, hw, 1)).astype(np.float32)
    normed[rng.random(normed.shape) < 0.25] = -1.0
    return (poses.reshape(b, -1), np.tile(cfg, (b, 1)), coms, normed)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


CASES = [(3, 8), (3, 32), (16, 8), (16, 32)]


@pytest.mark.parametrize("j,head", CASES)
def test_heatmaps_and_offsets_match_jax(j, head):
    poses, cfgs, coms, normed = scene(j, head)
    got = targets.hm2d(*_t(poses, cfgs), head, head)
    want = jtargets.hm2d(poses, cfgs, head, head)
    assert got.shape == (3, head, head, j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert got.max() > 0.5          # the cones lie on the grid

    tiny = normed[:, ::4, ::4]
    xyzs = jgeometry.backproject_dm(tiny, cfgs, coms)
    npose = jgeometry.norm_xyz_pose(poses, coms)
    om_j = jtargets.offset_maps(npose, xyzs)
    om = targets.offset_maps(*_t(np.asarray(npose), np.asarray(xyzs)))
    np.testing.assert_allclose(om.numpy(), np.asarray(om_j), atol=1e-6)
    np.testing.assert_allclose(targets.hm3d(om).numpy(),
                               np.asarray(jtargets.hm3d(om_j)), atol=1e-6)
    hm3_j = jtargets.hm3d(om_j)
    np.testing.assert_allclose(
        targets.resume_offset_maps(*_t(np.asarray(hm3_j),
                                       np.asarray(om_j))).numpy(),
        np.asarray(jtargets.resume_offset_maps(hm3_j, om_j)), atol=1e-6)


@pytest.mark.parametrize("j,head", CASES)
def test_synthesize_matches_jax(j, head):
    poses, cfgs, coms, normed = scene(j, head, seed=1)
    got = targets.synthesize(*_t(poses, cfgs, coms, normed), head, head)
    want = jtargets.synthesize(poses, cfgs, coms, normed, head, head)
    for key in ("hm2", "hm3", "om", "tiny_dm"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, err_msg=key)
    # um: away from the mask edge d = 0.79, where the two packages' d may
    # round to opposite sides
    d = MAX_DIST_3D - np.asarray(want["hm3"]) * MAX_DIST_3D
    edge = np.repeat(np.abs(d - (MAX_DIST_3D - 1e-2)) < 1e-5, 3, axis=-1)
    diff = np.abs(got["um"].numpy() - np.asarray(want["um"]))
    assert diff[~edge].max() <= 1e-5
    assert edge.mean() < 1e-3
    assert (np.asarray(want["um"]) != 0).any()     # some pixels in range


def test_unit_offsets_mask_edge():
    """``um`` is ``om / d`` where ``d < 0.79`` and exactly 0 elsewhere, d
    taken from hm3."""
    om = np.array([[[[0.3, 0.4, 0.0, 0.8, 0.0, 0.0]]]], np.float32)
    hm3 = jtargets.hm3d(jnp.asarray(om))
    got = targets.unit_offset_maps(*_t(om, np.asarray(hm3))).numpy()
    np.testing.assert_allclose(got, np.asarray(
        jtargets.unit_offset_maps(om, hm3)), atol=1e-6)
    np.testing.assert_allclose(got[..., :3], [[[[0.6, 0.8, 0.0]]]], atol=1e-6)
    assert (got[..., 3:] == 0).all()
