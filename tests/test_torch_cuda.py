"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU with the CUDA toolkit (the kernels are built
by nvcc on first use) and skip elsewhere. They import no JAX, so that they
run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances. The fused decode (K1) and the mean shift (K2): 6e-6
normalized (PARITY.md, fused-decode row), against the plain version
evaluated on the CPU (``chip_smoke.plain_on_cpu`` says why not on the
card), NaN for NaN on the edge cases; the kernels repeat the plain
arithmetic operation by operation and what is left is their correctly
rounded exponential against the CPU's float ``exp``, within 1 ulp. The int8 GEMM (K3):
``q`` bit-identical and ``f`` within 1 ulp of its plain version on the
card, whose float64 product is exact; the same for its implicit-GEMM
convolution entry against im2col and the plain GEMM; an int8 net on K3
equal to the same net on the CPU. The depthwise int8 convolution: the same
standard as K3, on both of its load paths and at the ties of its
requantisation, and the lite int8 net on it, K3 and the quantize kernel
equal to the CPU's,
also at MSRA's J = 21 (85-channel depthwise, 170- and 105-channel K3
inputs, a 63-channel head), whose channels-last heads K1 reads on its
strided path. The quantize kernel: ``q`` bit-identical, ``f`` and
the scale equal to its plain form on the card at every step shape of the
lite net and at the values where rounding and clamping decide, one launch
a call. The
subnormal scene (``decode_subnormal_scene``):
K1 and K2 flush as the plain decode does. The serving daemon: no error
reply, every request answered, K1 once a batch and K3 once a convolution
of each int8 forward run on the host, a CUDA graph's capture included
and its replays not (``chip_smoke.phase_daemon``); the same for the
port's daemon load probe (``densereg_torch.tools.serve_probe``), and its
trace summary (``densereg_torch.tools.trace_summary``) names K1 and K3 in
a trace of one int8 dispatch.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import numpy as np  # noqa: E402

from chip_smoke import (  # noqa: E402
    DECODE_SHAPES,
    K1_PATH,
    TIE_KWS,
    TIE_SCALES,
    as_served,
    decode_edge_scene,
    decode_scene,
    decode_subnormal_scene,
    dw_operands,
    dw_tie_scene,
    nan_equal_err,
    plain_on_cpu,
    vote_edge_cases,
)
from densereg_torch import decode  # noqa: E402
from densereg_torch.models import layers  # noqa: E402
from densereg_torch.ops import fused_decode as ops  # noqa: E402
from densereg_torch.ops import int8_dwconv as dw  # noqa: E402
from densereg_torch.ops import int8_gemm as k3  # noqa: E402
from densereg_torch.ops import int8_layout  # noqa: E402
from densereg_torch.ops import meanshift as k2  # noqa: E402


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
@pytest.mark.parametrize("layout", sorted(K1_PATH))
@pytest.mark.parametrize("hw", [32, 64, 128])
@pytest.mark.parametrize("j", [1, 14, 16, 21, 32])
def test_fused_decode_lone_frame(cuda, j, hw, layout):
    """One frame (one block a joint group), every k from 1 to 8, each
    layout: NHWC views of NCHW heads, and any one-joint heads (a plane),
    take the planes path; channels-last heads read along the channels
    where J % 4 == 0 and fall to the strided path otherwise."""
    scene = decode_scene(np.random.default_rng(j * hw), 2, hw, hw, j)
    args = as_served(tuple(a[1:] for a in scene), cuda, layout)
    path = ("planes" if j == 1 or layout == "nchw" else
            K1_PATH[layout] if j % 4 == 0 else "strided")
    for k in range(1, 9):
        want = ops.fused_decode_reference(*(t.cpu() for t in args), num_pt=k)
        before = dict(ops.fused_decode.launches_by_path)
        got = ops.fused_decode(*args, num_pt=k)
        torch.cuda.synchronize()
        assert ops.fused_decode.launches_by_path[path] == before[path] + 1
        assert got.shape == (1, j, 3) and torch.isfinite(got).all()
        assert (got.cpu() - want).abs().max().item() <= 6e-6, k


@pytest.mark.cuda
def test_fused_decode_int8_heads_at_21_joints(cuda):
    """K1 at MSRA's J = 21 on heads as the int8 net serves them
    (channels-last float32, a K3 epilogue's f), at the serving batch of
    256: J % 4 != 0, so one launch on the strided path, no copy; against
    the plain decode on the CPU."""
    args = as_served(decode_scene(np.random.default_rng(21), 256, 32, 32,
                                  21), cuda, "nhwc")
    assert args[0].stride() == (32 * 32 * 21, 32 * 21, 21, 1)
    want = plain_on_cpu(args)
    before = dict(ops.fused_decode.launches_by_path)
    got = ops.fused_decode(*args)
    torch.cuda.synchronize()
    assert ops.fused_decode.launches_by_path["strided"] == \
        before["strided"] + 1
    assert sum(ops.fused_decode.launches_by_path.values()) == \
        sum(before.values()) + 1
    assert got.shape == (256, 21, 3) and torch.isfinite(got).all()
    assert (got.cpu() - want).abs().max().item() <= 6e-6


@pytest.mark.cuda
def test_fused_decode_reads_any_strides(cuda):
    """Heads cut from wider tensors (pixel and row strides that are not
    the served ones) and a transposed depth view take the strided path and
    agree with the plain decode."""
    scene = decode_scene(np.random.default_rng(9), 3, 32, 32, 16)
    hms, hm3s, ums, tiny, cfgs, coms = (torch.from_numpy(a).to(cuda)
                                        for a in scene)
    wide = lambda t: torch.cat([t, t[..., :3]], -1)[..., :t.shape[-1]]
    args = (wide(hms), wide(hm3s), wide(ums),
            tiny.transpose(1, 2).contiguous().transpose(1, 2), cfgs, coms)
    before = ops.fused_decode.launches_by_path["strided"]
    got = ops.fused_decode(*args)
    torch.cuda.synchronize()
    assert ops.fused_decode.launches_by_path["strided"] == before + 1
    assert (got.cpu() - plain_on_cpu(args)).abs().max().item() <= 6e-6


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(K1_PATH))
def test_fused_decode_edge_cases(cuda, layout):
    """All weights 0 or negative, scores all 0, a NaN and an infinite
    weight (chip_smoke.decode_edge_scene), against the plain decode on the
    CPU, NaN for NaN. The NaN weight keeps the cell-63 start, JAX's answer
    (tests/test_torch_decode.py pins it against the JAX package)."""
    args = as_served(decode_edge_scene(np.random.default_rng(5), 8, 32, 32,
                                       16), cuda, layout)
    got = ops.fused_decode(*args).cpu()
    assert nan_equal_err(got, plain_on_cpu(args)) <= 6e-6
    assert torch.equal(got[3, 0], torch.full((3,), 0.75))
    assert torch.isnan(got[4, 1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(K1_PATH))
def test_fused_decode_subnormal_scene(cuda, layout):
    """Joints whose Gaussian weights fall in float32's subnormal range:
    K1 flushes them as the plain decode (and XLA) does, within 6e-6; those
    whose weights all underflow keep their start. Then K2 on the same
    candidates and weights."""
    scene = decode_subnormal_scene(np.random.default_rng(0), 8, 32, 32, 16)
    args = as_served(scene, cuda, layout)
    want = plain_on_cpu(args)
    got = ops.fused_decode(*args).cpu()
    assert (got - want).abs().max().item() <= 6e-6
    _, cans, weights = decode.decode_plain(*(t.cpu() for t in args))
    want = decode.weighted_mean_shift(cans, weights, 10, 0.4)
    got = k2.weighted_mean_shift_cuda(cans.to(cuda), weights.to(cuda), 10,
                                      0.4).cpu()
    assert (got - want).abs().max().item() <= 6e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(vote_edge_cases()))
def test_meanshift_edge_cases(cuda, name):
    """K2 on the vote's edge cases against the plain version on the CPU
    (tests/test_torch_meanshift.py holds that against the JAX package),
    NaN for NaN; a NaN weight keeps the cell-63 start."""
    cans, weights = (torch.from_numpy(a)[None]
                     for a in vote_edge_cases()[name])
    want = decode.weighted_mean_shift(cans, weights, 10, 0.4)
    got = k2.weighted_mean_shift_cuda(cans.to(cuda), weights.to(cuda), 10,
                                      0.4).cpu()
    assert nan_equal_err(got, want) <= 6e-6
    if name == "nan_weight":
        assert torch.equal(got, torch.full((1, 2, 3), 0.75))


@pytest.mark.cuda
def test_refused_launches_raise(cuda, monkeypatch):
    """A launch that the C entry refuses (here k = 9, past its 8-lane
    tail, with the wrappers' own checks lifted) raises and counts
    nothing."""
    args = as_served(decode_scene(np.random.default_rng(0), 2, 32, 32, 16),
                     cuda)
    monkeypatch.setattr(ops, "MAX_PICKS", 9)
    monkeypatch.setattr(k2, "MAX_CANDIDATES", 9)
    before = (ops.fused_decode.launches, k2.weighted_mean_shift_cuda.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.fused_decode(*args, num_pt=9)
    with pytest.raises(RuntimeError, match="launch failed"):
        k2.weighted_mean_shift_cuda(torch.zeros((1, 1, 9, 3), device=cuda),
                                    torch.zeros((1, 1, 9), device=cuda))
    assert (ops.fused_decode.launches,
            k2.weighted_mean_shift_cuda.launches) == before


def _gemm_operands(rng, m, k, n, device):
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
    sc = torch.from_numpy(rng.uniform(1e-4, 1e-3, n).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-2, 2, n).astype(np.float32))
    return [t.to(device) for t in (x, w, sc, b)] + [
        torch.tensor(0.5, device=device)]


# (M, K, N): the s2/f128 int8 graph's odd widths (stem im2col 49, hm3_res
# 131 -> 65 and its 3x3 585, um_fc1 515), tiles cut at every edge, and an
# aligned shape; M not a multiple of the 128-row tile
K3_SHAPES = [(300, 49, 32), (1000, 131, 65), (517, 585, 65), (129, 515, 512),
             (256, 64, 64), (77, 16, 16), (1, 1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", K3_SHAPES,
                         ids=[f"{m}x{k}x{n}" for m, k, n in K3_SHAPES])
@pytest.mark.parametrize("relu", [True, False])
def test_int8_gemm_matches_plain(cuda, m, k, n, relu):
    """q bit-identical and f (float32 and bfloat16) within 1 ulp of the
    plain version on the card, whose float64 product is exact."""
    args = _gemm_operands(np.random.default_rng(m + k + n), m, k, n, cuda)
    for emit in ((True, False), (False, True), (True, True)):
        for f_dtype in (torch.float32, torch.bfloat16):
            kw = dict(relu=relu, emit_q=emit[0], emit_f=emit[1],
                      f_dtype=f_dtype)
            before = k3.int8_gemm_requant.launches
            q, f = k3.int8_gemm_requant(*args, **kw)
            q_p, f_p = k3.int8_gemm_requant_reference(*args, **kw)
            torch.cuda.synchronize()
            assert k3.int8_gemm_requant.launches == before + 1
            assert (q is None) == (not emit[0]) and (f is None) == (not emit[1])
            if q is not None:
                assert q.shape == (m, n) and q.stride(0) % 16 == 0
                assert torch.equal(q, q_p)
            if f is not None:
                assert f.dtype == f_dtype and f.shape == (m, n)
                step = torch.finfo(f_dtype).eps * f_p.float().abs().clamp_min(
                    torch.finfo(f_dtype).tiny)
                assert ((f.float() - f_p.float()).abs() <= step).all()


@pytest.mark.cuda
def test_int8_gemm_reads_strided_operands(cuda):
    """x as a row-padded view (the layers' layout) and w as a (K, N) view
    of an (N, K) tensor (no copy), against contiguous copies."""
    x, w, sc, b, sy = _gemm_operands(np.random.default_rng(1), 200, 131, 65,
                                     cuda)
    xp = torch.zeros((200, 144), dtype=torch.int8, device=cuda)[:, :131]
    xp.copy_(x)
    wt = w.t().contiguous().t()
    want = k3.int8_gemm_requant(x, w, sc, b, sy, emit_f=True)
    got = k3.int8_gemm_requant(xp, wt, sc, b, sy, emit_f=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _pitched(rng, shape, c, device):
    """Random int8 ``shape + (c,)`` as a view of a tensor whose last axis is
    padded to 16 bytes, with random int8 (-128 included) in the padding, as
    an activation's never-written pitch bytes may hold."""
    full = rng.integers(-128, 128, shape + (-(-c // 16) * 16,)).astype(np.int8)
    full[..., :c] = rng.integers(-127, 128, shape + (c,))
    return torch.from_numpy(full).to(device)[..., :c]


def _assert_matches_plain(got, want):
    q, f = got
    q_p, f_p = want
    assert (q is None) == (q_p is None) and (f is None) == (f_p is None)
    if q is not None:
        assert q.shape == q_p.shape and torch.equal(q, q_p)
    if f is not None:
        assert f.dtype == f_p.dtype and f.shape == f_p.shape
        step = torch.finfo(f.dtype).eps * f_p.float().abs().clamp_min(
            torch.finfo(f.dtype).tiny)
        assert ((f.float() - f_p.float()).abs() <= step).all()


@pytest.mark.cuda
def test_int8_gemm_ignores_pitch_bytes(cuda):
    """The dense entry reads whole 16-byte chunks of x and w: whatever the
    bytes past K hold, x's (never written) and w's (cut at K by the
    kernel), the result is that of clean contiguous operands."""
    rng = np.random.default_rng(7)
    x, w, sc, b, sy = _gemm_operands(rng, 333, 131, 65, cuda)
    xp = _pitched(rng, (333,), 131, cuda)
    xp.copy_(x)
    wp = _pitched(rng, (65,), 131, cuda)
    wp.copy_(w.t())
    kw = dict(emit_q=True, emit_f=True, f_dtype=torch.float32)
    got = k3.int8_gemm_requant(xp, wp.t(), sc, b, sy, **kw)
    want = k3.int8_gemm_requant(x.contiguous(), w.contiguous(), sc, b, sy,
                                **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _assert_matches_plain(got, k3.int8_gemm_requant_reference(
        x, w, sc, b, sy, **kw))


# (k, stride, C, N, h = w): every k x k convolution of the s2/f128 int8 net
# (the 7x7/2 stem over C = 1, the residuals' 3x3 at each width and map
# size down to the hourglass's 2x2), and a 3x3/2 on an odd map
CONV_SHAPES = [(7, 2, 1, 32, 128), (3, 1, 16, 16, 64), (3, 1, 32, 32, 32),
               (3, 1, 64, 64, 32), (3, 1, 64, 64, 16), (3, 1, 64, 64, 8),
               (3, 1, 64, 64, 4), (3, 1, 64, 64, 2), (3, 1, 65, 65, 32),
               (3, 1, 80, 80, 32), (3, 1, 128, 128, 32),
               (3, 1, 256, 256, 32), (3, 2, 80, 80, 9)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,stride,c,n,hw", CONV_SHAPES,
                         ids=[f"{k}x{k}s{s}-c{c}-n{n}-{hw}"
                              for k, s, c, n, hw in CONV_SHAPES])
def test_int8_conv_matches_plain(cuda, k, stride, c, n, hw):
    """The implicit-GEMM entry against im2col and the plain GEMM on the
    card, at batch 2, with random bytes in every pixel's pitch and the
    image edges zero-padded by the loader: q bit-identical, f within 1
    ulp, and no im2col on the card."""
    rng = np.random.default_rng(k * c + hw)
    x = _pitched(rng, (2, hw, hw), c, cuda)
    kern = torch.from_numpy(rng.integers(-127, 128, (k, k, c, n)).astype(
        np.int8)).to(cuda)
    w = k3.pack_weight(kern)
    kk = k * k * c
    sc = torch.from_numpy((rng.uniform(0.5, 1.5, n) / (5400.0 * kk ** 0.5))
                          .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.uniform(-1, 1, n).astype(np.float32)).to(cuda)
    sy = torch.tensor(0.02, device=cuda)
    for relu in (True, False):
        for emit in ((True, False), (False, True), (True, True)):
            for f_dtype in (torch.float32, torch.bfloat16):
                kw = dict(relu=relu, emit_q=emit[0], emit_f=emit[1],
                          f_dtype=f_dtype)
                before = (k3.int8_gemm_requant.launches,
                          k3.im2col_nhwc.cuda_calls)
                got = k3.int8_conv_requant(x, w, k, stride, sc, b, sy, **kw)
                after = (k3.int8_gemm_requant.launches,
                         k3.im2col_nhwc.cuda_calls)
                want = k3.int8_conv_requant_reference(x, w, k, stride, sc, b,
                                                      sy, **kw)
                torch.cuda.synchronize()
                assert after == (before[0] + 1, before[1])
                oh = -(-hw // stride)
                for t in got:
                    assert t is None or t.shape == (2, oh, oh, n)
                if got[0] is not None:
                    assert got[0].stride(2) % 16 == 0
                _assert_matches_plain(got, want)
    assert len(torch.unique(got[0])) > 20        # the steps are exercised


@pytest.mark.cuda
def test_int8_conv_refuses_what_it_cannot_take(cuda, monkeypatch):
    """A pixel pitch that is not a multiple of 16 raises (no quiet copy),
    and so does a launch the card refuses for its shared memory."""
    rng = np.random.default_rng(3)
    kern = torch.zeros((3, 3, 65, 8), dtype=torch.int8, device=cuda)
    w = k3.pack_weight(kern)
    sc = torch.ones(8, device=cuda)
    b = torch.zeros(8, device=cuda)
    dense = torch.from_numpy(rng.integers(-127, 128, (1, 5, 5, 65)).astype(
        np.int8)).to(cuda)
    with pytest.raises(ValueError, match="16-byte"):
        k3.int8_conv_requant(dense, w, 3, 1, sc, b, 1.0)
    x = _pitched(rng, (1, 5, 5), 65, cuda)
    monkeypatch.setattr(k3, "STAGES", 16)       # 16 x 36 KB: over 227 KB
    before = k3.int8_gemm_requant.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        k3.int8_conv_requant(x, w, 3, 1, sc, b, 1.0)
    with pytest.raises(RuntimeError, match="launch failed"):
        k3.int8_gemm_requant(x.reshape(25, 65), w[:, :65].t(), sc, b, 1.0)
    assert k3.int8_gemm_requant.launches == before
    monkeypatch.undo()
    k3.int8_conv_requant(x, w, 3, 1, sc, b, 1.0)
    torch.cuda.synchronize()
    assert k3.int8_gemm_requant.launches == before + 1


# (C, h = w): every depthwise convolution of the s2/f128 lite int8 net (the
# stem's 16 and 32 channels, the hourglass's 64 down to its 2x2 maps, the
# heads' 65, 80, 128 and 256), and an odd map
DW_SHAPES = [(16, 64), (32, 32), (64, 32), (64, 16), (64, 8), (64, 4),
             (64, 2), (65, 32), (80, 32), (128, 32), (256, 32), (80, 9)]


def _dw_operands(rng, c, k, device):
    kern = torch.from_numpy(rng.integers(-127, 128, (k, k, 1, c)).astype(
        np.int8)).to(device)
    sc = torch.from_numpy((rng.uniform(0.5, 1.5, c) / (127.0 * 127.0 * k))
                          .astype(np.float32)).to(device)
    b = torch.from_numpy(rng.uniform(-0.5, 0.5, c).astype(np.float32)).to(
        device)
    return dw.pack_dw_weight(kern), sc, b, torch.tensor(0.01, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw", DW_SHAPES,
                         ids=[f"c{c}-{hw}" for c, hw in DW_SHAPES])
def test_int8_dwconv_matches_plain(cuda, c, hw):
    """The depthwise kernel against its plain version on the card, at batch
    3: the vector path on pixels 16 bytes apart with random bytes in their
    pitch (and a transposed view of them), the scalar path on a contiguous
    tensor of C = 65 and on channels two bytes apart; q bit-identical, f within 1 ulp, one launch a call,
    q's pixels 16 bytes apart."""
    rng = np.random.default_rng(c * 7 + hw)
    w, sc, b, sy = _dw_operands(rng, c, 3, cuda)
    pitched = _pitched(rng, (3, hw, hw), c, cuda)
    spread = torch.zeros((3, hw, hw, c, 2), dtype=torch.int8, device=cuda)
    spread[..., 0] = pitched
    inputs = [pitched, pitched.permute(0, 2, 1, 3),   # vector path
              pitched.contiguous(),        # vector where C % 16 == 0
              spread[..., 0]]              # channels 2 bytes apart: scalar
    for x in inputs:
        for relu in (True, False):
            for emit in ((True, False), (False, True), (True, True)):
                for f_dtype in (torch.float32, torch.bfloat16):
                    kw = dict(relu=relu, emit_q=emit[0], emit_f=emit[1],
                              f_dtype=f_dtype)
                    before = dw.int8_dwconv_requant.launches
                    got = dw.int8_dwconv_requant(x, w, 3, sc, b, sy, **kw)
                    want = dw.int8_dwconv_requant_reference(x, w, 3, sc, b,
                                                            sy, **kw)
                    torch.cuda.synchronize()
                    assert dw.int8_dwconv_requant.launches == before + 1
                    for t in got:
                        assert t is None or t.shape == x.shape
                    if got[0] is not None:
                        assert got[0].stride(2) == -(-c // 16) * 16
                    _assert_matches_plain(got, want)
    assert len(torch.unique(got[0])) > 20        # the steps are exercised


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
def test_int8_dwconv_other_windows(cuda, k):
    rng = np.random.default_rng(k)
    w, sc, b, sy = _dw_operands(rng, 65, k, cuda)
    x = _pitched(rng, (2, 11, 7), 65, cuda)
    kw = dict(emit_q=True, emit_f=True, f_dtype=torch.float32)
    _assert_matches_plain(dw.int8_dwconv_requant(x, w, k, sc, b, sy, **kw),
                          dw.int8_dwconv_requant_reference(x, w, k, sc, b,
                                                           sy, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 5])
def test_int8_dwconv_largest_lite_shape(cuda, k):
    """Each window size at the largest depthwise call of the lite int8 net
    (batch 256, 32x32, C = 256) and its plan: q alone, bfloat16 f alone
    and both with float32 f, against the plain version."""
    args = dw_operands(np.random.default_rng(20 + k), (256, 32, 32), 256, k,
                       cuda)
    for emit_q, emit_f, f_dtype in ((True, False, torch.bfloat16),
                                    (False, True, torch.bfloat16),
                                    (True, True, torch.float32)):
        kw = dict(emit_q=emit_q, emit_f=emit_f, f_dtype=f_dtype)
        _assert_matches_plain(dw.int8_dwconv_requant(*args, **kw),
                              dw.int8_dwconv_requant_reference(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("s_y", TIE_SCALES)
def test_int8_dwconv_requant_ties(cuda, s_y):
    """y at (n + 1/2) * s_y and 1 to 3 ulps around it
    (``chip_smoke.dw_tie_scene``): the kernel's reciprocal requantisation
    gives the division's q, bit for bit, with and without a ReLU folded
    into it."""
    args = dw_tie_scene(np.random.default_rng(11), s_y, cuda)
    for kw in TIE_KWS:
        _assert_matches_plain(dw.int8_dwconv_requant(*args, **kw),
                              dw.int8_dwconv_requant_reference(*args, **kw))


@pytest.mark.cuda
def test_int8_dwconv_refuses_what_it_cannot_take(cuda, monkeypatch):
    """A window it is not built for raises; a launch the C entry refuses
    (k = 7, with the wrapper's check lifted) raises and counts nothing;
    operands on two devices raise."""
    rng = np.random.default_rng(4)
    w, sc, b, sy = _dw_operands(rng, 32, 7, cuda)
    x = _pitched(rng, (1, 9, 9), 32, cuda)
    with pytest.raises(NotImplementedError, match="built"):
        dw.int8_dwconv_requant(x, w, 7, sc, b, sy)
    monkeypatch.setattr(dw, "KERNEL_SIZES", (1, 3, 5, 7))
    before = dw.int8_dwconv_requant.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        dw.int8_dwconv_requant(x, w, 7, sc, b, sy)
    assert dw.int8_dwconv_requant.launches == before
    with pytest.raises(ValueError, match="one device"):
        dw.int8_dwconv_requant(x, w.cpu(), 7, sc, b, sy)


@pytest.mark.cuda
def test_int8_dwconv_refuses_a_plan_short_of_its_layout(cuda, monkeypatch):
    """The C entry holds the host's plan to the kernel's own layout
    (``csrc/int8_dwconv.cu::smem_bytes``): a block one byte of shared
    memory or one thread short of it is refused, nothing launched or
    counted; the plan as made launches, so the two counts agree."""
    rng = np.random.default_rng(5)
    w, sc, b, sy = _dw_operands(rng, 32, 3, cuda)
    x = _pitched(rng, (2, 9, 9), 32, cuda)
    plan = dw.plan_launch(2, 9, 9, 32, 3)
    for short in (dataclasses.replace(plan, smem=plan.smem - 1),
                  dataclasses.replace(plan, threads=plan.threads - 1)):
        monkeypatch.setattr(dw, "plan_launch", lambda *a, p=short: p)
        before = dw.int8_dwconv_requant.launches
        with pytest.raises(RuntimeError, match="launch failed"):
            dw.int8_dwconv_requant(x, w, 3, sc, b, sy)
        assert dw.int8_dwconv_requant.launches == before
    monkeypatch.setattr(dw, "plan_launch", lambda *a: plan)
    _assert_matches_plain(dw.int8_dwconv_requant(x, w, 3, sc, b, sy),
                          dw.int8_dwconv_requant_reference(x, w, 3, sc, b,
                                                           sy))


@pytest.mark.cuda
def test_int8_lite_net_card_matches_cpu(cuda):
    """A calibrated int8 ``um_v1_lite`` net, every depthwise convolution
    on the depthwise kernel and every other on K3, against the same net on
    the CPU: heads and every int8 step equal; one depthwise launch a
    residual."""
    from chip_smoke import int8_net, int8_steps
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables
    from densereg_torch.models.bridge import seeded_depth

    cfg = NetConfig(num_stack=2, num_fea=32, num_joint=14, input_hw=(64, 64),
                    net_module="um_v1_lite")
    variables = init_variables(cfg, seed=1)
    x = torch.from_numpy(seeded_depth(np.random.default_rng(2), 3, 64, 64))
    cpu = int8_net(variables, cfg, "cpu", x)
    card = int8_net(variables, cfg, cuda, x)
    before = dw.int8_dwconv_requant.launches
    want, q_want = int8_steps(cpu, x)
    got, q_got = int8_steps(card, x.to(cuda))
    residuals = sum(isinstance(m, layers.Residual) for m in card.modules())
    assert dw.int8_dwconv_requant.launches == before + residuals
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert torch.equal(g, w), key
    assert q_got.keys() == q_want.keys()
    assert all(torch.equal(q_got[k], q) for k, q in q_want.items())


@pytest.mark.cuda
def test_int8_lite_net_at_21_joints_card_matches_cpu(cuda):
    """The calibrated int8 ``um_v1_lite`` at MSRA's J = 21 and the paper's
    128 features, on 32x32 crops: K3 meets 170- and 105-channel inputs and
    a 63-channel output, DW 85 and 65 channels. Heads and every int8
    step equal to the same net on the CPU."""
    from chip_smoke import int8_net, int8_steps
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables
    from densereg_torch.models.bridge import seeded_depth

    cfg = NetConfig(num_stack=2, num_fea=128, num_joint=21,
                    input_hw=(32, 32), net_module="um_v1_lite")
    variables = init_variables(cfg, seed=3)
    x = torch.from_numpy(seeded_depth(np.random.default_rng(4), 3, 32, 32))
    cpu = int8_net(variables, cfg, "cpu", x)
    card = int8_net(variables, cfg, cuda, x)
    before = dict(layers.int8_counts)
    want, q_want = int8_steps(cpu, x)
    mid = dict(layers.int8_counts)
    got, q_got = int8_steps(card, x.to(cuda))
    steps = {k: layers.int8_counts[k] - mid[k] for k in mid}
    # each standalone quantize step one launch of the quantize kernel on
    # the card, none on the CPU; every other step alike
    assert steps["quantize_kernel"] == steps["quantize"] == 53
    assert (dict(steps, quantize_kernel=0)
            == {k: mid[k] - before[k] for k in mid})
    assert steps["dw"] == 29 and steps["dynamic"] == 0
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert torch.equal(g, w), key
    assert q_got.keys() == q_want.keys()
    assert all(torch.equal(q_got[k], q) for k, q in q_want.items())


@pytest.mark.cuda
def test_quantize_divides_exactly_on_the_card(cuda):
    """The consumer-side quantize: on the card as on the CPU, including the
    values next to every .5 boundary (a multiply by the reciprocal would
    move some of them across)."""
    s = torch.tensor(0.0123, dtype=torch.float32)
    steps = torch.arange(-127.5, 128.0, 1.0) * s
    near = torch.cat([torch.nextafter(steps, steps - 1), steps,
                      torch.nextafter(steps, steps + 1)])
    x = torch.cat([near, torch.randn(100_000) * 2.0])
    want = int8_layout.quantize(x, s)
    got = int8_layout.quantize(x.to(cuda), s.to(cuda))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(layers.act_scale(x.abs().amax().to(cuda)).cpu(),
                       layers.act_scale(x.abs().amax()))


# (h, w, C, with the addend) of every standalone quantize step of the s2/f128
# int8 um_v1_lite net at J = 21 on 128x128 crops (the stem's depth, the
# sums, the concatenations 105, 131, 170 and 515)
LITE_QUANTIZE_STEPS = [
    (128, 128, 1, False), (64, 64, 64, True), (32, 32, 64, True),
    (32, 32, 105, False), (32, 32, 128, False), (32, 32, 128, True),
    (32, 32, 131, False), (32, 32, 170, False), (32, 32, 256, True),
    (32, 32, 512, False), (32, 32, 512, True), (32, 32, 515, False),
    (16, 16, 128, False), (16, 16, 128, True), (8, 8, 128, True),
    (4, 4, 128, True), (2, 2, 128, True)]


def _quantize_matches_plain(a, b, amax):
    """One launch of the quantize kernel against its plain form on the
    card: q bit-identical (and laid out alike), f and s equal; counted on
    the path its operands call for (16 bytes a thread where C % 16 == 0
    and the inputs start at 16-byte multiples, else element by
    element)."""
    from densereg_torch.ops import int8_quantize as iq

    launches = iq.int8_quantize.launches
    by_path = dict(iq.int8_quantize.launches_by_path)
    q, f, s = iq.int8_quantize(a, amax, b)
    assert iq.int8_quantize.launches == launches + 1
    flat = a.shape[-1] % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (a, b) if t is not None)
    want = "flat" if flat else "elements"
    assert {p: n - by_path[p]
            for p, n in iq.int8_quantize.launches_by_path.items()} == {
        p: int(p == want) for p in iq.PATHS}
    q0, f0, s0 = iq.int8_quantize_reference(a, b, amax)
    assert q.stride() == q0.stride()
    assert torch.equal(q, q0)
    assert torch.equal(s, s0) or (s.isnan().item() and s0.isnan().item())
    if b is None:
        assert f is None
    else:
        assert f.dtype == a.dtype
        assert torch.equal(f.isnan(), f0.isnan())
        assert torch.equal(f.nan_to_num(0.0), f0.nan_to_num(0.0))
    return q, f, s


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("h,w,c,with_b", LITE_QUANTIZE_STEPS,
                         ids=[f"{h}x{w}x{c}" + ("-sum" if b else "")
                              for h, w, c, b in LITE_QUANTIZE_STEPS])
def test_int8_quantize_matches_plain(cuda, h, w, c, with_b, dtype):
    """The quantize kernel at every step shape of the lite net at b = 256:
    one launch a call, against the plain form on the card."""
    g = torch.Generator(device=cuda).manual_seed(h * 1000 + c)
    a = (torch.randn((256, h, w, c), generator=g, device=cuda) * 3).to(dtype)
    b = ((torch.randn((256, h, w, c), generator=g, device=cuda) * 3)
         .to(dtype) if with_b else None)
    # a calibrated maximum below the batch's: the clamp at +-127 is met
    amax = (a.float() if b is None else a.float() + b.float()).abs().amax()
    _quantize_matches_plain(a, b, amax * 0.8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
def test_int8_quantize_edge_cases(cuda, dtype):
    """Exact half steps and their neighbours, the clamp's edges, +-inf,
    +-0 and NaN, amax 0, NaN and inf, on both of the kernel's paths (C = 32
    by 16 bytes, C = 24 and a misaligned C = 32 element by element), with
    and without the addend; the plain form on the card equals the CPU's."""
    from test_torch_int8_quantize import edge_values

    for amax in (0.93, 0.0, float("nan"), float("inf")):
        amax = torch.tensor(amax)
        s = torch.tensor(0.93 / 127)
        vals = edge_values(s).to(dtype)
        n = vals.numel() - vals.numel() % 96
        for c, offset in ((32, 0), (24, 0), (32, 1)):
            flat = torch.zeros(2 * n + 2 * offset, dtype=dtype)
            flat[offset:offset + n] = vals[:n]
            flat[n + 2 * offset:] = torch.flip(vals[:n], (0,))
            flat = flat.to(cuda)
            a = flat[offset:offset + n].view(-1, 4, c)
            b = flat[n + 2 * offset:].view(-1, 4, c)
            for addend in (None, b):
                q, f, s_out = _quantize_matches_plain(a, addend,
                                                      amax.to(cuda))
                q_cpu, _, _ = (torch.ops.densereg.int8_quantize.default(
                    a.cpu(), None if addend is None else addend.cpu(), amax))
                assert torch.equal(q.cpu(), q_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16),
                         ids=("f32", "bf16"))
@pytest.mark.parametrize("lead,c", [
    ((3, 5, 7), 105), ((2, 9, 9), 515), ((1, 1, 1), 17), ((4, 6, 6), 24),
    ((2, 3, 3), 1), ((5, 7), 3), ((2, 33, 33), 170), ((2, 1, 1), 2100),
    ((300,), 131), ((2, 2, 2), 16), ((7, 3), 48)],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_int8_quantize_any_width(cuda, lead, c, dtype):
    """Widths and row counts beyond the nets': flat (C % 16 == 0), other
    widths (below 16, odd, wide) element by element; with and without the
    addend, and at an input that starts off a 16-byte multiple."""
    g = torch.Generator(device=cuda).manual_seed(c)
    n = int(np.prod(lead)) * c
    flat = (torch.randn(n + 1, generator=g, device=cuda) * 3).to(dtype)
    b = (torch.randn((*lead, c), generator=g, device=cuda) * 3).to(dtype)
    amax = flat.float().abs().amax() * 0.7
    for off in (0, 1):
        a = flat[off:off + n].view(*lead, c)
        _quantize_matches_plain(a, None, amax)
        _quantize_matches_plain(a, b, amax)


@pytest.mark.cuda
def test_int8_calibration_on_the_card_matches_cpu(cuda):
    """Calibrating the lite int8 net at J = 21 on the card: each
    standalone quantize step one launch of the quantize kernel, and every
    recorded maximum (``amax``, ``out_amax``) bit-equal to the CPU's."""
    from chip_smoke import int8_net
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables
    from densereg_torch.models.bridge import seeded_depth

    cfg = NetConfig(num_stack=2, num_fea=128, num_joint=21,
                    input_hw=(32, 32), net_module="um_v1_lite")
    variables = init_variables(cfg, seed=5)
    x = torch.from_numpy(seeded_depth(np.random.default_rng(6), 3, 32, 32))
    cpu = int8_net(variables, cfg, "cpu", x)
    before = dict(layers.int8_counts)
    card = int8_net(variables, cfg, cuda, x)
    steps = {k: layers.int8_counts[k] - before[k] for k in before}
    assert steps["quantize"] > 0
    assert steps["quantize_kernel"] == steps["quantize"]
    maxima = lambda net: {k: v for k, v in net.state_dict().items()
                          if k.endswith("amax")}
    want, got = maxima(cpu), maxima(card)
    assert want.keys() == got.keys() and want
    for key, w in want.items():
        assert torch.equal(got[key].cpu(), w), key


@pytest.mark.cuda
def test_int8_quantize_refuses_what_it_cannot_take(cuda):
    """A strided input, an amax off the card, or mismatched addends raise
    before a launch."""
    from densereg_torch.ops import int8_quantize as iq

    a = torch.randn(2, 8, 8, 32, device=cuda)
    amax = torch.tensor(1.0, device=cuda)
    launches = iq.int8_quantize.launches
    for args in ((a[..., :16], amax), (a, amax.cpu()), (a, amax, a[:1]),
                 (a, amax, a.bfloat16()), (a.double(), amax)):
        with pytest.raises((ValueError, TypeError)):
            iq.int8_quantize(*args)
    assert iq.int8_quantize.launches == launches


@pytest.mark.cuda
def test_int8_net_card_matches_cpu(cuda):
    """A calibrated int8 net, every convolution on K3, against the same
    net on the CPU: heads and every int8 step equal."""
    from chip_smoke import int8_net, int8_steps
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables
    from densereg_torch.models.bridge import seeded_depth

    cfg = NetConfig(num_stack=2, num_fea=32, num_joint=14, input_hw=(64, 64))
    variables = init_variables(cfg, seed=1)
    x = torch.from_numpy(seeded_depth(np.random.default_rng(2), 3, 64, 64))
    cpu = int8_net(variables, cfg, "cpu", x)
    card = int8_net(variables, cfg, cuda, x)
    before = k3.int8_gemm_requant.launches
    want, q_want = int8_steps(cpu, x)
    got, q_got = int8_steps(card, x.to(cuda))
    assert k3.int8_gemm_requant.launches > before
    for key in want:
        for g, w in zip(got[key], want[key]):
            assert torch.equal(g, w), key
    assert q_got.keys() == q_want.keys()
    assert all(torch.equal(q_got[k], q) for k, q in q_want.items())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 8])
def test_meanshift_matches_plain(cuda, n):
    """Vote ties and all-zero weights, against the plain version on the
    CPU (the card's exp rounds otherwise than the CPU's)."""
    rng = np.random.default_rng(n)
    cans = (rng.integers(-4, 5, (64, 16, n, 3)) * 0.22).astype(np.float32)
    cans += rng.normal(0.0, 0.02, cans.shape).astype(np.float32)
    weights = (rng.integers(0, 4, (64, 16, n)) * 0.25).astype(np.float32)
    weights[0] = 0.0
    cans, weights = torch.from_numpy(cans), torch.from_numpy(weights)
    want = decode.weighted_mean_shift(cans, weights, 10, 0.4)
    before = k2.weighted_mean_shift_cuda.launches
    got = k2.weighted_mean_shift_cuda(cans.to(cuda), weights.to(cuda), 10,
                                      0.4)
    torch.cuda.synchronize()
    assert k2.weighted_mean_shift_cuda.launches == before + 1
    assert (got.cpu() - want).abs().max().item() <= 6e-6
    with pytest.raises(ValueError, match="candidates"):
        k2.weighted_mean_shift_cuda(torch.zeros((1, 1, 9, 3), device=cuda),
                                    torch.zeros((1, 1, 9), device=cuda))


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


@pytest.mark.cuda
def test_test_driver_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """The test driver (``train.loop.test``) on one padded batch (6 frames,
    batch 8) from converted weights: the card's result lines against the
    CPU's under ``chip_smoke.eval_card_vs_cpu``'s rule, and K1 launched once,
    on the float nets' staging path."""
    from chip_smoke import eval_card_vs_cpu, run_test
    from densereg_torch import EvalConfig, NetConfig
    from densereg_torch.convert import save_converted
    from densereg_torch.data import synthetic
    from densereg_torch.models import init_variables

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=16, input_hw=(32, 32))
    variables = init_variables(cfg, seed=4)
    payload = str(tmp_path / "params.msgpack")
    save_converted({**variables, "renorm_t": 0.0}, payload)
    spec = synthetic.make_spec("testing", directory=str(tmp_path / "synth"),
                               num_shards=1, samples_per_shard=6)
    before = ops.fused_decode.launches
    hm_pixels = ops.fused_decode.launches_by_path["hm_pixels"]
    ecfg = EvalConfig(batch_size=8)
    card = run_test(spec, cfg, str(tmp_path / "card"), cuda, ecfg,
                    init_params=payload)
    assert ops.fused_decode.launches == before + 1
    assert ops.fused_decode.launches_by_path["hm_pixels"] == hm_pixels + 1
    cpu = run_test(spec, cfg, str(tmp_path / "cpu"), "cpu", ecfg,
                   init_params=payload)
    assert ops.fused_decode.launches == before + 1
    assert card[1] == cpu[1] and len(card[1]) == 6 and len(card[3]) == 17
    row = eval_card_vs_cpu(card[2], cpu[2], variables, cfg, spec, cuda)
    assert row["joints_off_unexplained"] == 0, row


@pytest.mark.cuda
def test_daemon_on_card(cuda, tmp_path, monkeypatch):
    """The daemon over a float32 and a calibrated int8 ``Predictor`` at a
    small size, 4 concurrent clients of 64 frames each; every check of
    ``chip_smoke.phase_daemon`` raises if off."""
    from chip_smoke import phase_daemon
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=16, input_hw=(32, 32))
    launches = phase_daemon(init_variables(cfg, seed=4), cfg, cuda,
                            str(tmp_path), per_client=64, max_batch=32,
                            n_calib=8)
    assert launches["fused_decode"] >= 2 * 256 // 32
    # the int8 batches replay the forward's CUDA graph the warm-up
    # captured (phase_daemon counts K3's calls on the host)
    assert launches["graph_replays"] > 0


@pytest.mark.cuda
def test_export_on_card(cuda, tmp_path, monkeypatch):
    """Float32, bfloat16 and calibrated int8 artifacts exported on the card
    at a small size, loaded and held against the live predictors; K1 and K3
    launched from inside the loaded programs (counters and the profiler's
    kernel names); a Server on the int8 artifact. Every check of
    ``chip_smoke.phase_export`` raises if off."""
    from chip_smoke import phase_export
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=16, input_hw=(32, 32))
    launches = phase_export(init_variables(cfg, seed=4), cfg, cuda,
                            str(tmp_path), n_frames=64, max_batch=32,
                            n_calib=8)
    assert launches["fused_decode"] > 0 and launches["int8_gemm_requant"] > 0


@pytest.mark.cuda
def test_multigpu_on_card(cuda, tmp_path):
    """A one-rank NCCL group: the synchronized step against the plain step
    and Predictor(mesh=...) against Predictor, at a small size
    (``chip_smoke.phase_multigpu``)."""
    from chip_smoke import phase_multigpu
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables

    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=16, input_hw=(32, 32))
    launches = phase_multigpu(init_variables(cfg, seed=4), cfg,
                              str(tmp_path), str(tmp_path / "train"),
                              n_frames=64, max_batch=32, n_calib=8)
    # the int8 mesh predictor replays the forward's CUDA graph its warm-up
    # captured (phase_multigpu counts K3's calls on the host)
    assert launches["fused_decode"] == 4 and launches["graph_replays"] > 0


@pytest.mark.cuda
def test_cli_on_card(cuda, tmp_path, monkeypatch):
    """The command line on the card at a small size: convert, train, test
    (and ``--init_params`` against ``train.loop.test``), export, predict
    through the checkpoint, the artifact and int8, serve in a child process
    and test in a one-rank NCCL group; every check of
    ``chip_smoke.phase_cli`` raises if off."""
    from chip_smoke import phase_cli
    from densereg_torch import NetConfig
    from densereg_torch.models import init_variables

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=16, input_hw=(32, 32))
    launches = phase_cli(init_variables(cfg, seed=4), cfg, cuda,
                         str(tmp_path))
    assert launches["fused_decode"] > 0 and launches["int8_gemm_requant"] > 0


def _tool_net(desc):
    from chip_smoke import SEED
    from densereg_torch.models import from_flax, init_variables
    from densereg_torch.tools.serve_probe import net_config

    cfg = net_config(desc)
    convs = sum(isinstance(m, layers.ConvBR) for m in from_flax(
        init_variables(cfg, seed=SEED), cfg).modules())
    return cfg, convs


@pytest.mark.cuda
def test_serve_probe_on_card(cuda):
    """``serve_probe --net s1f8 --device cuda --quantize`` self-hosted at a
    small size: no error reply, K1 once a daemon batch, K3 once a
    convolution of each int8 forward run on the host (a CUDA graph's
    capture included, its replays not), a 8-deep pipeline coalesced
    (``chip_smoke.tools_serve_probe``)."""
    from chip_smoke import host_forwards, tools_serve_probe

    _, convs = _tool_net("s1f8")
    rows, launches = tools_serve_probe("s1f8", True, convs, cuda,
                                       max_batch=8, depths=((1, 4), (8, 32)))
    assert [r["inflight"] for r in rows] == [1, 8]
    assert launches["int8_gemm_requant"] == convs * host_forwards(
        launches, launches["fused_decode"])
    assert launches["graph_replays"] > 0


@pytest.mark.cuda
def test_trace_summary_on_card(cuda, tmp_path):
    """``trace_summary`` on a ``torch.profiler`` trace of one dispatch of a
    calibrated int8 ``Predictor``: the K1 row 1 call, the K3 rows one call
    a convolution, no K2 or DW row, the rows summing to the trace's kernel
    time (``chip_smoke.tools_trace``)."""
    from chip_smoke import SEED, hand_frames, tools_latency_check, tools_trace

    _, convs = _tool_net("s1f8")
    gap, pred = tools_latency_check("s1f8", 8, True, cuda)
    assert gap <= 0.02
    frames, bbxs = hand_frames(np.random.default_rng(SEED), 8)
    out = tools_trace(pred, frames, bbxs, str(tmp_path), convs)
    assert out["calls_by_id"] == {"K1": 1, "K2": 0, "K3": convs, "DW": 0}
    assert out["ms_by_id"]["K1"] > 0 and out["ms_by_id"]["K3"] > 0
