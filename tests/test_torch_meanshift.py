"""K2: the port's weighted mean shift (the plain version of
``ops.meanshift.weighted_mean_shift_cuda``, which CPU tensors take)
against the JAX package's Pallas kernel in interpret mode, and on the
vote's edge cases against its jnp oracle (``decode.weighted_mean_shift``).

Inputs force the hazards of the kernel: vote ties between cells (the
start must be the LAST maximal cell), all-zero weights (the start is
kept), negative weights and votes of exactly 0 against the empty cells,
NaN candidates, NaN and infinite weights (every other cell's vote is NaN,
as in the one-hot sum). Tolerance 6e-6 normalized (PARITY.md, fused-decode
row): the sums over the candidates run in another order in JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402

from densereg_tpu import decode as jdecode  # noqa: E402
from densereg_tpu.ops.meanshift_pallas import (  # noqa: E402
    weighted_mean_shift_pallas,
)

from chip_smoke import vote_edge_cases  # noqa: E402
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


# --------------------------------------------------------------------------
# The vote's edge cases (chip_smoke.vote_edge_cases), against the JAX
# package's jnp oracle, and the occupied-cell rule of the kernels' shared
# tail (csrc/vote_meanshift.cuh) restated in numpy
# --------------------------------------------------------------------------

EDGE = vote_edge_cases()
FINITE = sorted(name for name, (c, w) in EDGE.items()
                if np.isfinite(c).all() and np.isfinite(w).all())


@pytest.mark.parametrize("name", sorted(EDGE))
def test_plain_matches_jax_on_edge_cases(name):
    """The plain mean shift (what CPU tensors take) against
    ``densereg_tpu.decode.weighted_mean_shift``: the same start (exactly)
    and the same result, NaN and infinities included; on the finite cases
    the Pallas kernel in interpret mode too."""
    cans, weights = EDGE[name]
    tc, tw = torch.from_numpy(cans), torch.from_numpy(weights)
    jc, jw = jnp.asarray(cans), jnp.asarray(weights)
    np.testing.assert_array_equal(decode._vote_grid_init(tc, tw).numpy(),
                                  np.asarray(jdecode._vote_grid_init(jc, jw)))
    got = weighted_mean_shift_cuda(tc, tw, 10, 0.4).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jdecode.weighted_mean_shift(jc, jw, 10, 0.4)),
        rtol=0, atol=TOL, equal_nan=True)
    if name in FINITE:
        np.testing.assert_allclose(
            got, np.asarray(weighted_mean_shift_pallas(
                jc[None], jw[None], 10, 0.4, interpret=True))[0],
            rtol=0, atol=TOL)


def _occupied_cell_start(cans, weights, grid=4):
    """The kernels' vote rule in numpy: only the occupied cells and the
    last empty one compete. An occupied cell votes, from 0 in candidate
    order, w_t for its candidates and w_t * 0 for the others (NaN for a NaN
    or infinite w_t); an empty cell votes the w_t * 0 alone. The largest
    vote wins, NaN above every number, ties to the larger index."""
    nq = grid // 2
    out = np.empty(cans.shape[:-2] + (3,), np.float32)
    for idx in np.ndindex(*cans.shape[:-2]):
        c, w = cans[idx], weights[idx]
        q = np.clip(np.nan_to_num((c + np.float32(1.0)) * np.float32(nq),
                                  nan=0.0), 0.0, np.float32(grid - 0.1))
        q = q.astype(np.int32)
        cell = (q[:, 0] * grid + q[:, 1]) * grid + q[:, 2]
        with np.errstate(invalid="ignore"):
            off = w * np.float32(0.0)
            votes = {}
            for ci in set(cell.tolist()):
                v = np.float32(0.0)
                for t in range(len(w)):
                    v = v + (w[t] if cell[t] == ci else off[t])
                votes[ci] = v
            empty = [ci for ci in range(grid ** 3) if ci not in votes]
            if empty:
                e = np.float32(0.0)
                for t in range(len(w)):
                    e = e + off[t]
                votes[empty[-1]] = e
        key = lambda ci: (bool(np.isnan(votes[ci])),
                          -np.inf if np.isnan(votes[ci]) else votes[ci], ci)
        best = max(votes, key=key)
        ix = np.array([best // (grid * grid), (best // grid) % grid,
                       best % grid], np.float32)
        out[idx] = ix / np.float32(nq) - np.float32(1.0) + np.float32(
            0.5 / nq)
    return out


@pytest.mark.parametrize("name", sorted(EDGE))
def test_occupied_cell_rule_matches_vote_grid_init(name):
    cans, weights = EDGE[name]
    np.testing.assert_array_equal(
        _occupied_cell_start(cans, weights),
        decode._vote_grid_init(torch.from_numpy(cans),
                               torch.from_numpy(weights)).numpy())


def test_edge_case_starts_are_pinned():
    """The starts the edge cases are built for (cell centres)."""
    c = lambda i: [(i // 16) * 0.5 - 0.75, ((i // 4) % 4) * 0.5 - 0.75,
                   (i % 4) * 0.5 - 0.75]
    want = {"all_negative": [63, 62, 61], "zero_vote": [63, 63, 63, 63],
            "one_cell": [0, 63], "nan_weight": [63, 63],
            "inf_weight": [63, 62, 63, 63]}
    for name, cells in want.items():
        cans, weights = (torch.from_numpy(a) for a in EDGE[name])
        np.testing.assert_array_equal(
            decode._vote_grid_init(cans, weights).numpy(),
            np.array([c(i) for i in cells], np.float32), err_msg=name)
    # a NaN weight: the start is kept (JAX's answer, the fault of the first
    # kernels, which started at the best other cell)
    cans, weights = (torch.from_numpy(a) for a in EDGE["nan_weight"])
    np.testing.assert_array_equal(
        weighted_mean_shift_cuda(cans, weights).numpy(),
        np.full((2, 3), 0.75, np.float32))
