"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels are built
by nvcc on first use) and skip elsewhere. They import no JAX, so that they
run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: 6e-6 normalized (PARITY.md, fused-decode row), against the
plain decode evaluated on the CPU (``chip_smoke.plain_on_cpu`` says why not
on the card). The kernel repeats the plain decode's arithmetic operation by
operation; what is left is ``expf`` against the CPU's ``exp``.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    DECODE_SHAPES,
    as_served,
    decode_scene,
    plain_on_cpu,
)
from densereg_torch.ops import fused_decode as ops  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,j", DECODE_SHAPES,
                         ids=[f"b{b}-{h}x{w}-j{j}" for b, h, w, j in
                              DECODE_SHAPES])
def test_fused_decode_matches_plain(cuda, b, h, w, j):
    """Forced ties, background, off-image reprojections and an all-zero
    weight frame, on NHWC views of NCHW heads as the serving path gives."""
    args = as_served(decode_scene(np.random.default_rng(j * h), b, h, w, j),
                     cuda)
    want = plain_on_cpu(args)
    before = ops.fused_decode.launches
    got = ops.fused_decode(*args)
    torch.cuda.synchronize()
    assert ops.fused_decode.launches == before + 1
    assert got.shape == (b, j, 3) and torch.isfinite(got).all()
    assert (got.cpu() - want).abs().max().item() <= 6e-6


@pytest.mark.cuda
def test_fused_decode_refuses_what_it_cannot_take(cuda):
    args = list(as_served(decode_scene(np.random.default_rng(0), 2, 32, 32,
                                       16), cuda))
    with pytest.raises(TypeError, match="float32"):
        ops.fused_decode(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="shape"):
        ops.fused_decode(args[0][..., :8], *args[1:])
    with pytest.raises(ValueError, match="num_pt"):
        ops.fused_decode(*args, num_pt=9)
