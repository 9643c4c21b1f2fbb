"""Subnormal float32 values in the decode: the port flushes them to zero as
XLA does on the CPU and the TPU (FTZ on results, DAZ on inputs), with no
process-wide switch: nothing here calls ``torch.set_flush_denormal``.

A mean-shift Gaussian weight exp(-3.125 d^2) lies in float32's subnormal
range for d^2 of about 28-33 normalized units (a candidate 530-570 mm from
the estimate). XLA drops it; a joint whose weights are all such keeps its
vote-grid start. Tolerance: 6e-6 normalized against the JAX decode on the
CPU (PARITY.md, fused-decode row), the kernels' limit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402

from densereg_tpu import decode as jdecode  # noqa: E402
from densereg_tpu.config import EvalConfig as JEvalConfig  # noqa: E402

from chip_smoke import decode_subnormal_scene, vote_edge_cases  # noqa: E402
from densereg_torch import decode  # noqa: E402
from densereg_torch.ops import fused_decode as ops  # noqa: E402

TOL = 6e-6
FLT_MIN = np.finfo(np.float32).tiny


def test_flush_subnormals_as_xla_computes():
    """The helper against XLA's own results on the CPU: exp(-95),
    exp(-80) * 1e-5 and 1e-20 * 1e-20 are subnormal in IEEE float32 and 0
    in JAX; signs, normals, NaN and infinities pass."""
    x = torch.tensor([-95.0, -80.0])
    ieee = torch.exp(x) * torch.tensor([1.0, 1e-5])
    assert ((ieee > 0) & (ieee < FLT_MIN)).all()
    jax_says = np.asarray(jnp.exp(jnp.asarray([-95.0, -80.0], jnp.float32))
                          * jnp.asarray([1.0, 1e-5], jnp.float32))
    np.testing.assert_array_equal(jax_says, [0.0, 0.0])
    np.testing.assert_array_equal(decode.flush_subnormals(ieee).numpy(),
                                  jax_says)
    tiny = torch.tensor([1e-20]) * torch.tensor([1e-20])
    assert float(decode.flush_subnormals(tiny)) == 0.0 == float(
        jnp.asarray(1e-20, jnp.float32) * jnp.asarray(1e-20, jnp.float32))
    v = torch.tensor([-1e-40, 1e-40, FLT_MIN, -FLT_MIN, 1.5, float("nan"),
                      float("inf"), -float("inf"), -0.0])
    got = decode.flush_subnormals(v)
    assert torch.equal(torch.signbit(got), torch.signbit(v))
    np.testing.assert_array_equal(got.numpy(), [-0.0, 0.0, FLT_MIN, -FLT_MIN,
                                                1.5, np.nan, np.inf, -np.inf,
                                                -0.0])


@pytest.fixture(scope="module")
def scene():
    return decode_subnormal_scene(np.random.default_rng(0), 8, 32, 32, 16)


def _first_step_weights(cans, weights):
    """The first mean-shift step's Gaussian weights in float64, as IEEE
    float32 would have them before any flush."""
    start = decode._vote_grid_init(cans, weights).double()
    d2 = ((cans.double() - start[..., None, :]) ** 2).sum(-1)
    return torch.exp(-3.125 * d2) * weights.double()


def test_scene_reaches_subnormal_weights(scene):
    """The scene does what it is for: many joints' first-step weights are
    all subnormal (the estimate must stay), more are partly so."""
    out = decode.decode_poses(*(torch.from_numpy(a) for a in scene),
                              candidates=True)
    s = _first_step_weights(out["candidates"], out["weights"])
    sub = (s > 0) & (s < FLT_MIN)
    assert int(sub.all(-1).sum()) >= 20
    assert int((sub.any(-1) & ~sub.all(-1)).sum()) >= 5


def test_weighted_mean_shift_matches_jax_on_underflowing_weights(scene):
    """The mean shift alone, on the scene's candidates and weights and on
    the vote's edge cases, against the JAX package's (jnp)."""
    out = decode.decode_poses(*(torch.from_numpy(a) for a in scene),
                              candidates=True)
    cases = {"scene": (out["candidates"].numpy(), out["weights"].numpy()),
             **vote_edge_cases()}
    for name, (cans, w) in cases.items():
        got = decode.weighted_mean_shift(torch.from_numpy(cans),
                                         torch.from_numpy(w), 10, 0.4)
        want = np.asarray(jdecode.weighted_mean_shift(
            jnp.asarray(cans), jnp.asarray(w), 10, 0.4))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0,
                                   equal_nan=True, err_msg=name)


def test_decode_poses_matches_jax_on_subnormal_scene(scene):
    """The whole decode, and the fused kernel's plain version (what K1 is
    held to on the card), against the JAX decode: within 6e-6 normalized
    on every joint; the joints whose weights all underflow keep their
    vote-grid start."""
    args = [torch.from_numpy(a) for a in scene]
    want = jdecode.decode_poses(*(jnp.asarray(a) for a in scene),
                                JEvalConfig())
    got = decode.decode_poses(*args, candidates=True)
    np.testing.assert_allclose(got["normed"].numpy(),
                               np.asarray(want["normed"]), atol=TOL, rtol=0)
    np.testing.assert_allclose(ops.fused_decode_reference(*args).numpy(),
                               np.asarray(want["normed"]), atol=TOL, rtol=0)
    s = _first_step_weights(got["candidates"], got["weights"])
    stuck = ((s > 0) & (s < FLT_MIN)).all(-1)
    start = decode._vote_grid_init(got["candidates"], got["weights"])
    assert torch.equal(got["normed"][stuck], start[stuck])
