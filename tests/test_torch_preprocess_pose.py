"""The port's pose-driven crop (``preprocess_batch_from_pose``: the box
from the projected joints, the joint-depth background cull or a fixed
threshold, the center of mass) against the JAX package's, on synthetic
240x320 frames in uint16 and float32.

Tolerances: crop atol 1e-3 mm, cfgs rtol 1e-6, coms atol 1e-3 mm.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_tpu.preprocess import (  # noqa: E402
    preprocess_batch_from_pose as jpreprocess,
)

from densereg_torch.data.synthetic import CFG, render_sample  # noqa: E402
from densereg_torch.preprocess import (  # noqa: E402
    crop_from_xyz_pose,
    preprocess_batch_from_pose,
)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    samples = [render_sample(rng) for _ in range(4)]
    depth = np.stack([d for d, _ in samples])[..., None]
    poses = np.stack([p for _, p in samples])
    # one pose near the frame's corner: the box is clipped to the frame
    poses[3].reshape(-1, 3)[:, 0] -= 150.0
    return depth, poses


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("threshold", [None, 500.0, 430.0])
def test_pose_crop_matches_jax(frames, dtype, threshold):
    depth, poses = frames
    depth = depth.astype(dtype)
    cfg = np.asarray(CFG, np.float32)
    want = [np.asarray(a) for a in jpreprocess(depth, poses, cfg, 32, 32,
                                               threshold)]
    got = [t.numpy() for t in preprocess_batch_from_pose(
        torch.from_numpy(depth), torch.from_numpy(poses),
        torch.from_numpy(cfg), 32, 32, threshold)]
    assert got[0].shape == (4, 32, 32, 1) and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], atol=1e-3, rtol=0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], atol=1e-3, rtol=0)
    assert (got[0] > 0).mean() > 0.05            # the hand is in the crop


def test_background_cull():
    """Without a fixed threshold, pixels at or beyond the nearest joint
    surface (> 100 mm) + 250 mm are zeroed; readings <= 100 mm are not
    joint depths."""
    h, w = 40, 40
    cfg = torch.tensor([50.0, 50.0, 20.0, 20.0, w, h])
    pose = torch.tensor([[0.0, 0.0, 400.0, 20.0, 20.0, 420.0]])
    dm = torch.full((1, h, w), 900.0)
    dm[0, 18:24, 18:24] = 400.0           # the hand around both joints
    dm[0, 20, 20] = 50.0                  # a bad reading under joint 0
    crop, _ = crop_from_xyz_pose(dm, pose, cfg, 16, 16)
    # joint 0 reads 50 (ignored), joint 1 reads 400 (at u, v = 22.5, 22.5
    # truncated to 22): threshold 650, so the 900 mm background goes
    assert crop.max().item() <= 650.0 and (crop > 0).any()
    crop, _ = crop_from_xyz_pose(dm, pose, cfg, 16, 16,
                                 fixed_bg_threshold=1000.0)
    assert crop.max().item() == pytest.approx(900.0)
