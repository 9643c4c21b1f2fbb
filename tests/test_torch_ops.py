"""The port's slim op vocabulary (``densereg_torch/models/ops.py``) against
``densereg_tpu/models/ops.py`` on the same numpy inputs and weights, and the
depthwise int8 convolution's plain version (``ops.int8_dwconv``) against
XLA's grouped int8 convolution with K3's epilogue; what the depthwise
kernel decides on the host (``plan_launch``), and a float32 emulation of
its requantisation rule (``csrc/requant.cuh::requant_q_recip_step`` and
its ReLU form) against the division it replaces.

Tolerances: ``Deconv``, ``DepthwiseConv`` and ``Fc`` 1e-5 absolute on O(1)
outputs (float32 sums in another order); the stateless ops exactly, except
``avg_pool`` (1e-6: a sum of up to four terms in another order). The
depthwise int8 plain version: int32 sums equal, ``q`` bit-identical and
``f`` equal to the epilogue run op by op in JAX (inside ``jit`` XLA
contracts the multiply-add into an FMA).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from densereg_tpu.models import ops as jops  # noqa: E402

from chip_smoke import TIE_SCALES, requant_ties  # noqa: E402
from densereg_torch.models import ops  # noqa: E402
from densereg_torch.ops.int8_dwconv import (  # noqa: E402
    MAX_THREADS,
    SMS,
    TILES,
    int8_dwconv_requant,
    int8_dwconv_requant_reference,
    pack_dw_weight,
    plan_launch,
    tensor_map_path,
)


def _perturbed(variables, seed):
    """Flax's init (std 0.01) plus O(0.1) noise, so the outputs are O(1)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0.0, 0.3, a.shape).astype(np.float32), variables)


# (k, in, out, h, w): odd and even maps, in != out channels
DECONV_CASES = [(1, 3, 6, 4, 5), (3, 3, 6, 5, 4), (3, 8, 8, 8, 8),
                (5, 4, 7, 5, 6), (5, 6, 2, 8, 7)]


@pytest.mark.parametrize("k,cin,cout,h,w", DECONV_CASES,
                         ids=[f"k{c[0]}-{c[1]}to{c[2]}-{c[3]}x{c[4]}"
                              for c in DECONV_CASES])
def test_deconv_matches_flax_conv_transpose(k, cin, cout, h, w):
    """``lax.conv_transpose``'s SAME padding on a stride-2 dilation: the
    Flax HWIO kernel through the bridge's OIHW transpose, flipped and laid
    out (in, out) inside ``forward``; NHWC and NCHW give the same."""
    rng = np.random.default_rng(k * 100 + h)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)
    flax = jops.Deconv(cout, kernel=(k, k), stride=2)
    v = _perturbed(flax.init(jax.random.key(0), x), k)
    want = np.asarray(flax.apply(v, x))
    p = v["params"]["ConvTranspose_0"]
    ours = ops.Deconv(cin, cout, k, 2)
    ours.load_state_dict({
        "ConvTranspose_0.kernel": torch.from_numpy(
            p["kernel"].transpose(3, 2, 0, 1).copy()),
        "ConvTranspose_0.bias": torch.from_numpy(p["bias"])})
    with torch.inference_mode():
        got = ours(torch.from_numpy(x))
        nchw = ours(torch.from_numpy(x).permute(0, 3, 1, 2),
                    channels_last=False)
    assert got.shape == want.shape == (2, 2 * h, 2 * w, cout)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(),
                                  got.numpy())
    assert (want == 0).mean() > 0.2          # the ReLU acted


def test_conv_transpose_pads_follow_lax():
    """The SAME padding rule of ``lax.conv_transpose``, whose obvious
    stand-in (padding 1, output_padding 1) is wrong for a k = 3 kernel."""
    assert ops.conv_transpose_pads(3, 2) == (2, 1)
    assert ops.conv_transpose_pads(1, 2) == (0, 1)
    assert ops.conv_transpose_pads(5, 2) == (3, 2)
    assert ops.conv_transpose_pads(4, 2) == (2, 2)


def test_depthwise_conv_and_fc_match_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 7, 4)).astype(np.float32)
    flax = jops.DepthwiseConv(channel_multiplier=2)
    v = _perturbed(flax.init(jax.random.key(0), x), 1)
    p = v["params"]["Conv_0"]
    assert p["kernel"].shape == (3, 3, 1, 8)
    ours = ops.DepthwiseConv(4, channel_multiplier=2)
    ours.load_state_dict({
        "Conv_0.kernel": torch.from_numpy(p["kernel"].transpose(3, 2, 0, 1)
                                          .copy()),
        "Conv_0.bias": torch.from_numpy(p["bias"])})
    with torch.inference_mode():
        got = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(flax.apply(v, x)), atol=1e-5,
                               rtol=0)

    flat = x.reshape(2, -1)
    fc = jops.Fc(16)
    v = _perturbed(fc.init(jax.random.key(0), flat), 2)
    ours = ops.Fc(flat.shape[1], 16)
    ours.load_state_dict({f"Dense_0.{k}": torch.from_numpy(a)
                          for k, a in v["params"]["Dense_0"].items()})
    with torch.inference_mode():
        got = ours(torch.from_numpy(flat)).numpy()
    np.testing.assert_allclose(got, np.asarray(fc.apply(v, flat)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("window,stride", [(2, 2), (3, 2), (3, 1)])
def test_pools_match_jax(window, stride):
    x = np.random.default_rng(window * stride).normal(
        size=(2, 9, 10, 3)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(
        ops.max_pool(t, window, stride).numpy(),
        np.asarray(jops.max_pool(jnp.asarray(x), window, stride)))
    np.testing.assert_allclose(
        ops.avg_pool(t, window, stride).numpy(),
        np.asarray(jops.avg_pool(jnp.asarray(x), window, stride)),
        atol=1e-6, rtol=0)


def test_stateless_ops_match_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 3, 4)).astype(np.float32)
    t = torch.from_numpy(x)
    for factor in (1, 2, 4):
        np.testing.assert_array_equal(
            ops.upsampling_nearest(t, factor).numpy(),
            np.asarray(jops.upsampling_nearest(jnp.asarray(x), factor)))
    with pytest.raises(ValueError, match="power of two"):
        ops.upsampling_nearest(t, 3)
    np.testing.assert_array_equal(ops.flatten(t).numpy(),
                                  np.asarray(jops.flatten(jnp.asarray(x))))
    labels = np.asarray([0, 3, 1, -1, 4])
    np.testing.assert_array_equal(
        ops.one_hot_encoding(torch.from_numpy(labels), 4).numpy(),
        np.asarray(jops.one_hot_encoding(jnp.asarray(labels), 4)))
    assert ops.repeat_op(3, 1.0, lambda v, m: v * m, 2.0) == jops.repeat_op(
        3, 1.0, lambda v, m: v * m, 2.0) == 8.0


def test_dropout_keeps_scales_and_passes():
    x = torch.ones(4000)
    g = torch.Generator().manual_seed(0)
    y = ops.dropout(x, 0.5, g)
    assert set(y.unique().tolist()) <= {0.0, 2.0}
    assert 0.45 < float((y > 0).float().mean()) < 0.55
    assert torch.equal(y, ops.dropout(x, 0.5,
                                      torch.Generator().manual_seed(0)))
    assert ops.dropout(x, 0.0, g) is x


def _pitched_nhwc(rng, b, h, w, c):
    """Random int8 NHWC as a view of a tensor whose pixels are 16-byte
    aligned, with random int8 in the pitch bytes."""
    full = rng.integers(-128, 128, (b, h, w, -(-c // 16) * 16)).astype(
        np.int8)
    full[..., :c] = rng.integers(-127, 128, (b, h, w, c))
    return torch.from_numpy(full)[..., :c]


# (C, h, w): the um_v1_lite channel counts that are not multiples of 16
# (hm3_res; um_resA at J = 16 and at MSRA's J = 21) beside an aligned one;
# odd and even maps
DW_CASES = [(16, 8, 8), (65, 5, 6), (80, 7, 4), (85, 6, 5), (3, 2, 2)]


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("c,h,w", DW_CASES,
                         ids=[f"c{c}-{h}x{w}" for c, h, w in DW_CASES])
def test_dwconv_plain_matches_jax(c, h, w, k):
    """int32 sums equal to XLA's int8 convolution with
    ``feature_group_count = C`` (as ``densereg_tpu/models/layers.py`` runs
    it), then K3's epilogue: q bit-identical, f equal in both dtypes, with
    and without ReLU; the wrapper is the plain version on the CPU, and the
    pitch bytes of the input count for nothing."""
    rng = np.random.default_rng(c * 10 + k)
    x = _pitched_nhwc(rng, 2, h, w, c)
    kern = rng.integers(-127, 128, (k, k, 1, c)).astype(np.int8)
    sc = (rng.uniform(0.5, 1.5, c) / (127.0 * 127.0 * k)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, c).astype(np.float32)
    sy = np.float32(0.01)
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x.contiguous().numpy()), jnp.asarray(kern), (1, 1),
        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=c, preferred_element_type=jnp.int32)
    w_packed = pack_dw_weight(torch.from_numpy(kern))
    assert w_packed.shape == (k * k, -(-c // 16) * 16)
    assert (w_packed[:, c:] == 0).all()
    for relu in (True, False):
        with jax.disable_jit():
            y = acc.astype(jnp.float32) * sc + b
            if relu:
                y = jnp.maximum(y, 0.0)
            q_ref = np.asarray(jnp.clip(jnp.round(y / sy), -127, 127)
                               .astype(jnp.int8))
        for f_dtype in (torch.float32, torch.bfloat16):
            q, f = int8_dwconv_requant(
                x, w_packed, k, torch.from_numpy(sc), torch.from_numpy(b),
                torch.tensor(sy), relu=relu, emit_q=True, emit_f=True,
                f_dtype=f_dtype)
            assert q.shape == f.shape == acc.shape and f.dtype == f_dtype
            np.testing.assert_array_equal(q.numpy(), q_ref)
            want = np.asarray(y) if f_dtype == torch.float32 else np.asarray(
                jnp.asarray(y).astype(jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(f.float().numpy(), want)
    assert len(np.unique(q_ref)) > min(20, q_ref.size // 4)


def test_dwconv_refuses_what_it_cannot_take():
    x = torch.zeros((1, 4, 4, 20), dtype=torch.int8)
    w = pack_dw_weight(torch.zeros((3, 3, 1, 20), dtype=torch.int8))
    s, b = torch.ones(20), torch.zeros(20)
    with pytest.raises(ValueError, match="pack_dw_weight"):
        int8_dwconv_requant(x, w[:, :16], 3, s, b, 1.0)
    with pytest.raises(ValueError, match="pack_dw_weight"):
        int8_dwconv_requant(x, w, 5, s, b, 1.0)
    with pytest.raises(ValueError, match="emit_q or emit_f"):
        int8_dwconv_requant(x, w, 3, s, b, 1.0, emit_q=False)
    with pytest.raises(ValueError, match="s_y"):
        int8_dwconv_requant(x, w, 3, s, b)
    with pytest.raises(ValueError, match="scale"):
        int8_dwconv_requant(x, w, 3, torch.ones(16), b, 1.0)
    with pytest.raises(TypeError, match="f_dtype"):
        int8_dwconv_requant(x, w, 3, s, b, 1.0, emit_f=True,
                            f_dtype=torch.float16)
    with pytest.raises(ValueError, match="depthwise"):
        pack_dw_weight(torch.zeros((3, 3, 2, 20), dtype=torch.int8))
    q, _ = int8_dwconv_requant_reference(x, w, 3, s, b, 1.0)
    assert q.shape == x.shape and (q == 0).all()


# (h, w, C): calls a forward of every depthwise convolution of the s2/f128
# um_v1_lite int8 net, all k = 3 (41; chip_smoke.py counts them on the net)
LITE_DW_CALLS = {(64, 64, 16): 1, (32, 32, 32): 2, (32, 32, 64): 4,
                 (32, 32, 65): 2, (32, 32, 80): 4, (32, 32, 128): 4,
                 (32, 32, 256): 2, (16, 16, 64): 6, (8, 8, 64): 6,
                 (4, 4, 64): 6, (2, 2, 64): 4}
ODD_DW_SHAPES = [(5, 6, 3), (7, 4, 3), (5, 6, 65), (7, 4, 65)]
PLAN_CASES = ([(b, h, w, c, 3) for b in (1, 16, 256)
               for h, w, c in LITE_DW_CALLS]
              + [(b, h, w, c, k) for b in (1, 16, 256)
                 for h, w, c in ODD_DW_SHAPES for k in (1, 3, 5)])


@pytest.mark.parametrize("b,h,w,c,k", PLAN_CASES,
                         ids=[f"b{b}-{h}x{w}-c{c}-k{k}"
                              for b, h, w, c, k in PLAN_CASES])
def test_dwconv_plan_covers_every_item_once(b, h, w, c, k):
    """The depthwise kernel's launch plan: a tile it is built for, a
    thread for each 2 rows x 4 columns x 4 channels, at most 1,024 threads
    and 227 KB of shared memory a block; its blocks, decoded as the kernel
    decodes them, cover every (image, pixel, 16-channel chunk) exactly once
    and each covers some; at least one block an SM wherever the call has
    at least 64 items for each."""
    assert sum(LITE_DW_CALLS.values()) == 41
    plan = plan_launch(b, h, w, c, k)
    nchunks = -(-c // 16)
    assert (plan.th, plan.tw) in TILES and plan.cb in (16, 32, 64)
    assert plan.ipb & (plan.ipb - 1) == 0 and nchunks % (plan.cb // 16) == 0
    assert plan.threads * 2 * 4 * 4 == plan.ipb * plan.th * plan.tw * plan.cb
    assert plan.threads <= min(MAX_THREADS, 1024)
    assert plan.smem <= 227 * 1024
    count = np.zeros((b, h, w, nchunks), np.int32)
    for bz in range(plan.image_groups):
        for by in range(plan.groups):
            for bx in range(plan.tiles_x * plan.tiles_y):
                n0, y0, x0, k0 = plan.origin(bx, by, bz)
                part = count[n0:n0 + plan.ipb, y0:y0 + plan.th,
                             x0:x0 + plan.tw, k0:k0 + plan.cb // 16]
                assert part.size > 0
                part += 1
    assert (count == 1).all()
    if count.size >= SMS * 64:
        assert plan.blocks >= SMS


def _dw_layouts():
    """(name, int8 NHWC tensor, whether the kernel stages it with the
    tensor memory accelerator): the nets' pitched activations and views of
    them against layouts with channels apart, pixels off 16 bytes or a
    pointer off 16 bytes."""
    pitched = torch.zeros((2, 5, 6, 80), dtype=torch.int8)[..., :65]
    spread = torch.zeros((2, 5, 6, 16, 2), dtype=torch.int8)[..., 0]
    base = torch.zeros(32 + 2 * 5 * 6 * 16, dtype=torch.int8)
    shift = -base.data_ptr() % 16
    return [("pitched", pitched, True),
            ("pitched-transposed", pitched.permute(0, 2, 1, 3), True),
            ("contiguous-c16", torch.zeros((2, 5, 6, 16), dtype=torch.int8),
             True),
            ("contiguous-c65", torch.zeros((2, 5, 6, 65), dtype=torch.int8),
             False),
            ("channels-2-bytes-apart", spread, False),
            ("pointer-off-16", base[shift + 1:shift + 1 + 2 * 5 * 6 * 16]
             .view(2, 5, 6, 16), False)]


@pytest.mark.parametrize("name,x,staged", _dw_layouts(),
                         ids=[c[0] for c in _dw_layouts()])
def test_dwconv_tensor_map_path(name, x, staged):
    """Which inputs the depthwise kernel stages with the tensor memory
    accelerator (the C entry refuses a launch whose tensor map the driver
    rejects, so no such input is staged another way unreported): whole
    16-byte chunks of each pixel and 16-byte aligned pixels and pointer."""
    assert tensor_map_path(x) is staged


def _requant_q_reciprocal(y, s_y, relu=False):
    """float32 emulation of ``csrc/requant.cuh``'s reciprocal rule with
    ``recip_band``: ``requant_q_recip_step``, or with ``relu``
    ``requant_q_recip_relu_step`` and ``relu_bytes`` (y before its ReLU).
    Returns ``(q, divided)``, where ``divided`` marks the outputs in the
    band, which the division decides (on y after the ReLU)."""
    y, sy = np.asarray(y, np.float32), np.float32(s_y)
    magic = np.float32(1.5 * 2 ** 23)
    with np.errstate(all="ignore"):
        inv = np.float32(1.0) / sy
        normal = np.isfinite(inv) and abs(inv) >= np.finfo(np.float32).tiny
        band = np.float32(0.5 - 2.0 ** -15) if normal else np.float32(-1.0)
        r = y * inv
        if relu:
            s = np.clip(r * np.float32(2.0 ** -7), np.float32(0.0),
                        np.float32(1.0))
            t = np.where(np.isnan(s), np.float32(0.0), s) * np.float32(128.0)
        else:
            t = np.fmin(np.fmax(r, np.float32(-127.25)), np.float32(127.25))
        m = t + magic
        divided = ~(np.abs(t - (m - magic)) <= band)
        yr = np.maximum(y, np.float32(0.0)) if relu else y
        q_div = np.fmin(np.fmax(np.where(yr == 0, np.float32(0.0),
                                         np.rint(yr / sy)),
                                np.float32(-127)), np.float32(127))
    q_fast = (m.view(np.int32) & 0xFF).astype(np.int16)
    if relu:
        q_fast = np.where(q_fast == 128, 127, q_fast)   # relu_bytes
    q = np.where(divided, q_div.astype(np.int8),
                 q_fast.astype(np.uint8).view(np.int8))
    return q, divided


@pytest.mark.parametrize("relu", [False, True], ids=["plain", "relu"])
@pytest.mark.parametrize("s_y", TIE_SCALES)
def test_requant_reciprocal_rule_matches_division(s_y, relu):
    """The depthwise kernel's requantisation, ``fl(y * fl(1 / s_y))`` and
    rint by an add outside a band of 2^-15 around each half-integer (after
    a ReLU: a saturating multiply by 2^-7 for the clamp), equals
    ``rint(y / s_y)`` (of ``max(y, 0)``) clipped to +-127 bit for bit: on y
    at (n + 1/2) * s_y and 1 to 3 ulps on either side for n in -130..130,
    on 10^5 seeded y, and on 0, -0, +-inf and the largest floats. Every tie
    inside the clip range (and above 0 after a ReLU) takes the division; of
    the seeded y, fewer than 1 in 1,000."""
    ties = requant_ties(s_y)
    rng = np.random.default_rng(int(s_y * 1e4) + 1)
    spread = np.float32(s_y) * np.concatenate([
        rng.uniform(-140.0, 140.0, 90_000),
        rng.normal(0.0, 3.0, 10_000)]).astype(np.float32)
    big = np.finfo(np.float32).max
    edges = np.array([0.0, -0.0, np.inf, -np.inf, big, -big], np.float32)
    y = np.concatenate([ties, spread.astype(np.float32), edges])
    q, divided = _requant_q_reciprocal(y, s_y, relu)
    with np.errstate(all="ignore"):
        yr = np.maximum(y, np.float32(0.0)) if relu else y
        want = np.clip(np.rint(yr / np.float32(s_y)), -127, 127).astype(
            np.int8)
    np.testing.assert_array_equal(q, want)
    half = np.arange(-130, 131) + 0.5
    inside = (np.abs(half) < 127) & ((half > 0) if relu else True)
    assert divided[:261][inside].all()
    assert divided[ties.size:ties.size + spread.size].mean() < 1e-3
