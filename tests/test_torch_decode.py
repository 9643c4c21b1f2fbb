"""The port's plain decode (densereg_torch.decode) against the JAX package's
decode_poses (jnp path) and its fused Pallas kernel in interpret mode, on
the same numpy scenes.

Tolerances (PARITY.md): poses 2e-4 normalized against the jnp decode
(candidates 1e-5, weights 1e-6, as the literal-oracle test holds the jnp
decode); 6e-6 against the fused kernel. The port repeats the jnp decode's
arithmetic operation by operation, so the rounded reprojections pick the
same pixels; the remaining differences are summation order and exp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402

from densereg_tpu import decode as jdecode  # noqa: E402
from densereg_tpu.config import EvalConfig as JEvalConfig  # noqa: E402
from densereg_tpu.ops.fused_decode import fused_decode as jfused  # noqa: E402

from chip_smoke import as_served, decode_edge_scene, decode_scene  # noqa: E402
from densereg_torch import decode  # noqa: E402
from densereg_torch.ops import fused_decode as ops  # noqa: E402  (module)
from tests.test_decode_oracle import _random_scene  # noqa: E402
from tests.test_fused_decode import _scene  # noqa: E402

CASES = [(14, 128), (16, 128), (21, 128), (16, 256)]


def _make(kind, j, in_hw, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":
        hw = in_hw // 4
        scene = _random_scene(rng, b=3, j=j, h=hw, w=hw)
    else:
        scene = _scene(rng, b=2, j=j, noisy=kind == "noisy", in_hw=in_hw)
    hm, hm3, um, tiny, cfgs, coms = (np.array(a, np.float32) for a in scene)
    # frame 0 has no heatmap mass: every candidate weight is 0, so the
    # decode keeps the vote-grid start (the reference divides 0/0)
    hm[0] = 0.0
    return hm, hm3, um, tiny, cfgs, coms


@pytest.mark.parametrize("kind", ["clean", "noisy", "ties"])
@pytest.mark.parametrize("j,in_hw", CASES, ids=[f"j{j}-{h // 4}x{h // 4}"
                                                for j, h in CASES])
def test_plain_decode_matches_jax(kind, j, in_hw):
    scene = _make(kind, j, in_hw, seed=7 * j + in_hw)
    want = jdecode.decode_poses(*(jnp.asarray(a) for a in scene),
                                JEvalConfig())
    got = decode.decode_poses(*(torch.from_numpy(a) for a in scene),
                              candidates=True)

    assert got["normed"].shape == (scene[0].shape[0], j, 3)
    assert torch.isfinite(got["normed"]).all()
    np.testing.assert_allclose(got["candidates"].numpy(),
                               np.asarray(want["candidates"]), atol=1e-5)
    np.testing.assert_allclose(got["weights"].numpy(),
                               np.asarray(want["weights"]), atol=1e-6)
    assert (got["weights"][0] == 0).all()
    np.testing.assert_allclose(got["normed"].numpy(),
                               np.asarray(want["normed"]), atol=2e-4)
    np.testing.assert_allclose(got["xyz"].numpy(), np.asarray(want["xyz"]),
                               atol=2e-2)


@pytest.mark.parametrize("kind", ["clean", "noisy", "ties"])
@pytest.mark.parametrize("j,in_hw", CASES[:3], ids=[f"j{j}" for j, _ in
                                                    CASES[:3]])
def test_fused_reference_matches_pallas_interpret(kind, j, in_hw):
    """fused_decode on CPU tensors runs its plain version; it must agree
    with the TPU kernel (interpret mode) to the kernel's own tolerance, and
    it launches nothing."""
    scene = _make(kind, j, in_hw, seed=11 * j)
    want = np.asarray(jfused(*(jnp.asarray(a) for a in scene),
                             interpret=True))
    before = ops.fused_decode.launches
    got = ops.fused_decode(*(torch.from_numpy(a) for a in scene))
    assert ops.fused_decode.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=6e-6, rtol=0)


def test_top_k_takes_lower_index_on_ties():
    scores = torch.tensor([[0.5, 1.0, 0.5, 1.0, 0.25, 1.0, 0.5]])
    assert decode.top_k_first_index(scores, 5).tolist() == [[1, 3, 5, 0, 2]]


def test_vote_grid_keeps_last_cell_when_weights_vanish():
    """All-zero weights: every cell ties at 0, the last one (63) wins, and
    the mean shift keeps its center."""
    cans = torch.zeros((1, 5, 3))
    out = decode.weighted_mean_shift(cans, torch.zeros((1, 5)), 10, 0.4)
    np.testing.assert_array_equal(out.numpy(), [[0.75, 0.75, 0.75]])



@pytest.mark.parametrize("hw", [32, 64])
def test_plain_decode_matches_jax_on_served_layouts(hw):
    """Channels-last heads as the int8 net hands them over (``nhwc``), a
    channels-last hm beside NCHW hm3 and um as the float nets do
    (``mixed``), and NHWC views of NCHW heads (``nchw``), the depth a
    ``[::4, ::4]`` view of a full-size map in each: the plain decode gives
    the same poses for every layout, and they match the jnp decode."""
    scene = decode_scene(np.random.default_rng(hw), 4, hw, hw, 16)
    want = jdecode.decode_poses(*(jnp.asarray(a) for a in scene),
                                JEvalConfig())
    got = {layout: decode.decode_poses(*as_served(scene, "cpu", layout),
                                      candidates=True)
           for layout in ("nhwc", "nchw", "mixed")}
    assert got["nhwc"]["xyz"].shape == (4, 48)
    for key in ("normed", "candidates", "weights"):
        for layout in ("nchw", "mixed"):
            np.testing.assert_array_equal(got["nhwc"][key].numpy(),
                                          got[layout][key].numpy())
    np.testing.assert_allclose(got["nhwc"]["candidates"].numpy(),
                               np.asarray(want["candidates"]), atol=1e-5)
    np.testing.assert_allclose(got["nhwc"]["weights"].numpy(),
                               np.asarray(want["weights"]), atol=1e-6)
    np.testing.assert_allclose(got["nhwc"]["normed"].numpy(),
                               np.asarray(want["normed"]), atol=2e-4)


def test_plain_decode_matches_jax_on_edge_heads():
    """The fused kernel's edge-case frames (chip_smoke.decode_edge_scene):
    all weights 0, negative, scores all 0, a NaN and an infinite heatmap
    pixel picked as a candidate whose weight it becomes. The NaN weight
    keeps the cell-63 start, as in JAX; the infinite one gives NaN."""
    scene = decode_edge_scene(np.random.default_rng(5), 8, 32, 32, 16)
    want = jdecode.decode_poses(*(jnp.asarray(a) for a in scene),
                                JEvalConfig())
    got = decode.decode_poses(*(torch.from_numpy(a) for a in scene),
                              candidates=True)
    assert torch.isnan(got["weights"][3, 0, 0]) and torch.isinf(
        got["weights"][4, 1, 0])
    assert (got["weights"][1] <= 0).all() and (got["weights"][0] == 0).all()
    np.testing.assert_array_equal(got["normed"][3, 0].numpy(),
                                  [0.75, 0.75, 0.75])
    assert torch.isnan(got["normed"][4, 1]).all()
    np.testing.assert_allclose(got["normed"].numpy(),
                               np.asarray(want["normed"]), atol=2e-4,
                               equal_nan=True)
