"""K2: the port's weighted mean shift (the plain version of
``ops.meanshift.weighted_mean_shift_cuda``, which CPU tensors take)
against the JAX package's Pallas kernel in interpret mode.

Inputs force the two hazards of the kernel: vote ties between cells (the
start must be the LAST maximal cell) and all-zero weights (the start is
kept). Tolerance 6e-6 normalized (PARITY.md, fused-decode row): the sums
over the candidates run in another order in the Pallas kernel.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from densereg_tpu.ops.meanshift_pallas import (  # noqa: E402
    weighted_mean_shift_pallas,
)

from densereg_torch import decode  # noqa: E402
from densereg_torch.ops import weighted_mean_shift_cuda  # noqa: E402

TOL = 6e-6


def _problem(rng, b, j, n):
    """Candidates on a coarse lattice, so several fall into one vote cell
    and cells tie; weights on a coarse grid with exact ties; problem
    (0, 0) has all-zero weights and problem (0, 1) two equal clusters in
    the first and the last cell."""
    cans = (rng.integers(-4, 5, (b, j, n, 3)) * 0.22).astype(np.float32)
    cans += rng.normal(0.0, 0.02, cans.shape).astype(np.float32)
    weights = (rng.integers(0, 4, (b, j, n)) * 0.25).astype(np.float32)
    weights[0, 0] = 0.0
    if j > 1 and n >= 4:
        cans[0, 1, :2] = -0.9
        cans[0, 1, 2:4] = 0.9
        cans[0, 1, 4:] = 0.0
        weights[0, 1] = 0.0
        weights[0, 1, :4] = 1.0
    return cans, weights


@pytest.mark.parametrize("b,j,n,num_it", [(4, 16, 5, 10), (3, 7, 5, 5),
                                          (2, 21, 8, 10), (2, 14, 1, 3)])
def test_plain_matches_pallas(b, j, n, num_it):
    cans, weights = _problem(np.random.default_rng(b * j + n), b, j, n)
    want = np.asarray(weighted_mean_shift_pallas(
        jnp.asarray(cans), jnp.asarray(weights), num_it, 0.4,
        interpret=True))
    launches = weighted_mean_shift_cuda.launches
    got = weighted_mean_shift_cuda(torch.from_numpy(cans),
                                   torch.from_numpy(weights), num_it, 0.4)
    assert weighted_mean_shift_cuda.launches == launches  # CPU: plain
    assert got.shape == (b, j, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    plain = decode.weighted_mean_shift(torch.from_numpy(cans),
                                       torch.from_numpy(weights), num_it, 0.4)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


def test_ties_and_zero_weights():
    cans, weights = _problem(np.random.default_rng(0), 1, 2, 5)
    got = weighted_mean_shift_cuda(torch.from_numpy(cans),
                                   torch.from_numpy(weights), 0, 0.4)
    # all-zero weights: every cell votes 0 and the last cell starts
    np.testing.assert_allclose(got[0, 0].numpy(), [0.75, 0.75, 0.75])
    # two equal clusters: the later cell wins
    np.testing.assert_allclose(got[0, 1].numpy(), [0.75, 0.75, 0.75])
