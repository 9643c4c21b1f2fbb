"""int8 serving of ``um_v1`` in the port against the JAX package, on the
CPU: K3's plain version (``ops.int8_gemm``), ``quantize_weights``,
``calibrate``, the int8 net (dynamic and calibrated) and the int8
``Predictor``.

Tolerances. K3: int32 sums equal, ``q`` bit-identical, ``f`` equal to
``reference_gemm_requant``'s and within one rounding of the product of the
Pallas kernel's (XLA contracts its multiply-add into an FMA). The net:
heads 1e-4 per element (PARITY.md, network row). The JAX net is run op by
op for this: inside ``jit`` XLA's CPU compiler contracts ``y * scale +
bias`` into an FMA and turns ``amax / 127`` into a multiply by the
reciprocal, and either last-bit change flips int8 steps at their .5
boundaries (0.38 on a head element at this size). Op by op, the JAX net
computes what its source says, each operation rounded once, as the port
and its kernel do, and the heads come out bit-identical. The Predictor:
xyz 0.02 mm (PARITY.md, decode row), against the JAX Predictor run op by
op for the same reason.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from densereg_tpu import config as jconfig  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402
from densereg_tpu.models import fold_batch_norm as jfold  # noqa: E402
from densereg_tpu.models.quantize import (  # noqa: E402
    calibrate as jcalibrate,
    quantize_weights as jquantize_weights,
)
from densereg_tpu.ops.int8_gemm import (  # noqa: E402
    int8_gemm_requant as jgemm,
    reference_gemm_requant,
)
from densereg_tpu.serving import Predictor as JPredictor  # noqa: E402

from densereg_torch import NetConfig, Predictor  # noqa: E402
from densereg_torch.models import (  # noqa: E402
    act_stats_to_flax,
    calibrate,
    fold_batch_norm,
    from_flax,
    init_variables,
    quantize_weights,
    quantized_net_config,
)
from densereg_torch.models.bridge import seeded_depth  # noqa: E402
from densereg_torch.ops.int8_gemm import (  # noqa: E402
    im2col_nhwc,
    int8_conv_requant,
    int8_conv_requant_reference,
    int8_gemm_requant,
    int8_gemm_requant_reference,
    pack_weight,
    unpack_weight,
)
from densereg_torch.ops.int8_layout import quantize  # noqa: E402
from test_torch_serving import ICVL, _hand_frames  # noqa: E402

SHAPE = dict(num_stack=2, num_fea=16, num_joint=14, input_hw=(64, 64))
XYZ_ATOL_MM = 0.02


def _gemm_inputs(rng, m, k, n):
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sc = rng.uniform(1e-4, 1e-3, n).astype(np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    return x, w, sc, b, np.float32(0.05)


def _ours(x, w, sc, b, sy, **kw):
    t = lambda a: torch.from_numpy(np.asarray(a))
    q, f = int8_gemm_requant(t(x), t(w), t(sc), t(b), torch.tensor(sy), **kw)
    return (None if q is None else q.numpy(),
            None if f is None else f.float().numpy())


@pytest.mark.parametrize("relu", [True, False])
def test_k3_plain_matches_jax_tile_aligned(relu):
    x, w, sc, b, sy = _gemm_inputs(np.random.default_rng(int(relu)), 512,
                                   256, 256)
    acc = jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w),
                              (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(
        torch.from_numpy(x).long() @ torch.from_numpy(w).long(),
        np.asarray(acc))
    q_ref, f_ref = reference_gemm_requant(x, w, sc, b, sy, relu=relu)
    prod = np.asarray(acc).astype(np.float32) * sc
    for emit_q, emit_f in [(True, False), (False, True), (True, True)]:
        q, f = _ours(x, w, sc, b, sy, relu=relu, emit_q=emit_q,
                     emit_f=emit_f, f_dtype=torch.float32)
        q_k, f_k = jgemm(x, w, sc, b, sy, relu=relu, emit_q=emit_q,
                         emit_f=emit_f, f_dtype=jnp.float32, bm=256, bn=128,
                         interpret=True)
        assert (q is None) == (not emit_q) and (f is None) == (not emit_f)
        if emit_q:
            np.testing.assert_array_equal(q, np.asarray(q_ref))
            np.testing.assert_array_equal(q, np.asarray(q_k))
        if emit_f:
            np.testing.assert_array_equal(f, np.asarray(f_ref))
            # the FMA skips the rounding of the product: one ulp of it
            ulp = np.spacing(np.maximum(np.abs(prod), np.abs(f)))
            assert (np.abs(f - np.asarray(f_k)) <= ulp).all()
    _, f16 = _ours(x, w, sc, b, sy, relu=relu, emit_q=False, emit_f=True,
                   f_dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        f16, np.asarray(jnp.asarray(f_ref).astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("k", [49, 131, 515])
def test_k3_plain_matches_jax_ragged(k):
    """Widths of the s2/f128 int8 graph that the Pallas kernel refuses:
    the stem's im2col (49), hm3_res (131) and um_fc1 (515), N = 65."""
    x, w, sc, b, sy = _gemm_inputs(np.random.default_rng(k), 300, k, 65)
    sy = np.float32(0.5)
    q_ref, f_ref = reference_gemm_requant(x, w, sc, b, sy, relu=True)
    q, f = _ours(x, w, sc, b, sy, relu=True, emit_q=True, emit_f=True,
                 f_dtype=torch.float32)
    np.testing.assert_array_equal(q, np.asarray(q_ref))
    np.testing.assert_array_equal(f, np.asarray(f_ref))
    assert len(np.unique(q)) > 20          # the steps are exercised


def test_quantize_rounds_half_to_even_and_pads_rows():
    """On the CPU the wrapper is its plain version; ``quantize`` rounds half
    to even and its row-padded view holds the same values."""
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, 300.0, -300.0]])
    s = torch.tensor(1.0)
    np.testing.assert_array_equal(quantize(x, s).numpy(),
                                  [[0, 2, 2, 0, -2, 127, -127]])
    padded = quantize(x, s, pitch16=True)
    assert padded.stride(0) == 16
    np.testing.assert_array_equal(padded.numpy(), quantize(x, s).numpy())
    with pytest.raises(ValueError, match="s_y"):
        int8_gemm_requant_reference(torch.zeros((2, 3), dtype=torch.int8),
                                    torch.zeros((3, 4), dtype=torch.int8),
                                    torch.ones(4), torch.zeros(4))


@pytest.mark.parametrize("k,stride,hw", [(7, 2, 16), (3, 1, 8), (3, 2, 9)])
def test_im2col_conv_matches_integer_conv(k, stride, hw):
    """The int8 im2col times the HWIO kernel is the SAME convolution, with
    XLA's uneven pads (the 7x7/2 stem pads 2 before and 3 after)."""
    rng = np.random.default_rng(k * hw)
    x = rng.integers(-127, 128, (2, hw, hw, 5)).astype(np.int8)
    kern = rng.integers(-127, 128, (k, k, 5, 6)).astype(np.int8)
    cols, (b, oh, ow) = im2col_nhwc(torch.from_numpy(x), k, stride)
    assert cols.stride(0) % 16 == 0
    got = (cols.long() @ torch.from_numpy(kern).reshape(-1, 6).long())
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kern), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(got.reshape(b, oh, ow, 6).numpy(),
                                  np.asarray(want))


def _pitched_nhwc(rng, b, hw, c):
    """Random int8 NHWC as a view of a tensor whose pixels are 16-byte
    aligned, with random int8 in the (never-written) pitch bytes."""
    full = rng.integers(-128, 128, (b, hw, hw, -(-c // 16) * 16)).astype(
        np.int8)
    full[..., :c] = rng.integers(-127, 128, (b, hw, hw, c))
    return torch.from_numpy(full)[..., :c], full


# (k, stride, C, hw): the 7x7/2 stem over C = 1, 3x3 at aligned and ragged
# widths (65 -> Cp 80), and a 3x3/2 on an odd map
CONV_CASES = [(7, 2, 1, 16), (3, 1, 64, 9), (3, 1, 65, 8), (3, 2, 80, 9)]


@pytest.mark.parametrize("k,stride,c,hw", CONV_CASES,
                         ids=[f"{k}x{k}s{s}-c{c}-{hw}"
                              for k, s, c, hw in CONV_CASES])
def test_k3_conv_plain_matches_jax(k, stride, c, hw):
    """The implicit-GEMM entry's plain version against XLA's int8 SAME
    convolution (int32 sums) and the epilogue of ``reference_gemm_requant``
    (its operations, each rounded once, run op by op): q bit-identical, f
    equal, in both f dtypes and with and without ReLU."""
    rng = np.random.default_rng(k * c + hw)
    x, _ = _pitched_nhwc(rng, 2, hw, c)
    n = 24
    kern = rng.integers(-127, 128, (k, k, c, n)).astype(np.int8)
    kk = k * k * c
    sc = (rng.uniform(0.5, 1.5, n) / (5400.0 * kk ** 0.5)).astype(np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    sy = np.float32(0.02)
    acc = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(kern), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    w = pack_weight(torch.from_numpy(kern))
    for relu in (True, False):
        with jax.disable_jit():
            y = acc.astype(jnp.float32) * sc + b
            if relu:
                y = jnp.maximum(y, 0.0)
            q_ref = np.asarray(jnp.clip(jnp.round(y / sy), -127, 127)
                               .astype(jnp.int8))
        for f_dtype in (torch.float32, torch.bfloat16):
            q, f = int8_conv_requant(
                x, w, k, stride, torch.from_numpy(sc), torch.from_numpy(b),
                torch.tensor(sy), relu=relu, emit_q=True, emit_f=True,
                f_dtype=f_dtype)
            assert q.shape == f.shape == acc.shape
            np.testing.assert_array_equal(q.numpy(), q_ref)
            want = np.asarray(y) if f_dtype == torch.float32 else np.asarray(
                jnp.asarray(y).astype(jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(f.float().numpy(), want)
    assert len(np.unique(q_ref)) > 20          # the steps are exercised


@pytest.mark.parametrize("k,stride,c,hw", CONV_CASES,
                         ids=[f"{k}x{k}s{s}-c{c}-{hw}"
                              for k, s, c, hw in CONV_CASES])
def test_packed_weight_ignores_pitch_bytes(k, stride, c, hw):
    """What the kernel computes: the pitch bytes read along with every
    pixel meet the packed weights' zeros, so the int32 sums over the whole
    16-byte chunks equal ``im2col_nhwc`` @ HWIO over the C channels."""
    rng = np.random.default_rng(c + hw)
    x, full = _pitched_nhwc(rng, 2, hw, c)
    n = 7
    kern = torch.from_numpy(rng.integers(-127, 128, (k, k, c, n)).astype(
        np.int8))
    w = pack_weight(kern)
    assert w.shape == (n, k * k * -(-c // 16) * 16)
    assert torch.equal(unpack_weight(w, k, c), kern.reshape(-1, n))
    cols, shape = im2col_nhwc(x, k, stride)
    want = cols.long() @ kern.reshape(-1, n).long()
    cols_full, _ = im2col_nhwc(torch.from_numpy(full), k, stride)
    got = cols_full.long() @ w.t().long()
    assert (full[..., c:] != 0).any() or c % 16 == 0
    assert torch.equal(got, want)
    q, _ = int8_conv_requant_reference(
        x, w, k, stride, torch.ones(n), torch.zeros(n), 1e9, relu=False)
    assert q.shape == shape + (n,)


def test_conv_entry_refuses_a_foreign_weight():
    x = torch.zeros((1, 4, 4, 20), dtype=torch.int8)
    with pytest.raises(ValueError, match="pack_weight"):
        int8_conv_requant(x, torch.zeros((8, 9 * 20), dtype=torch.int8), 3,
                          1, torch.ones(8), torch.zeros(8), 1.0)


@pytest.fixture(scope="module")
def trees():
    variables = init_variables(NetConfig(**SHAPE), seed=3)
    folded = fold_batch_norm(variables)
    # jitted: op by op the JAX function compiles once per weight shape
    jquant = jax.tree.map(np.asarray, jax.jit(jquantize_weights)(
        jfold(variables)))
    return variables, folded, jquant


def test_quantize_weights_matches_jax(trees):
    _, folded, jquant = trees
    ours = quantize_weights(folded)
    flat = lambda t: dict(
        (jax.tree_util.keystr(p), np.asarray(a))
        for p, a in jax.tree_util.tree_flatten_with_path(t)[0])
    ours, theirs = flat(ours), flat(jquant)
    assert ours.keys() == theirs.keys()
    for key, a in ours.items():
        b = theirs[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if a.dtype == np.int8:
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), key


@pytest.fixture(scope="module")
def jax_int8(trees):
    """The JAX int8 net op by op on a hand-like batch: dynamic heads,
    calibrated statistics and calibrated heads."""
    _, _, jquant = trees
    dms = seeded_depth(np.random.default_rng(5), 2, 64, 64)
    net = JNet(jconfig.NetConfig(**SHAPE, fold_bn=True, quantize=True))
    with jax.disable_jit():
        dynamic = net.apply(jquant, jnp.asarray(dms), train=False)
        calibrated = jcalibrate(net, jquant, [jnp.asarray(dms)])
        static = net.apply(calibrated, jnp.asarray(dms), train=False)
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return dms, to_np(dynamic), to_np(calibrated["act_stats"]), to_np(static)


def _heads_match(got, want):
    for key in ("hm", "hm3", "um"):
        assert len(got[key]) == 2
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["dynamic", "calibrated"])
def test_int8_net_matches_jax(trees, jax_int8, mode):
    _, _, jquant = trees
    dms, dynamic, act_stats, static = jax_int8
    variables = dict(jquant)
    if mode == "calibrated":
        variables["act_stats"] = act_stats
    net = from_flax(variables, NetConfig(**SHAPE))
    assert net.cfg.quantize and net.cfg.fold_bn
    with torch.inference_mode():
        got = net(torch.from_numpy(dms))
    _heads_match(got, dynamic if mode == "dynamic" else static)


def test_calibrate_matches_jax(trees, jax_int8):
    _, _, jquant = trees
    dms, _, act_stats, _ = jax_int8
    net = from_flax(jquant, NetConfig(**SHAPE))
    calibrate(net, [torch.from_numpy(dms)])
    ours = act_stats_to_flax(net)
    flat = lambda t: dict(
        (jax.tree_util.keystr(p), float(a))
        for p, a in jax.tree_util.tree_flatten_with_path(t)[0])
    ours, theirs = flat(ours), flat(act_stats)
    assert ours.keys() == theirs.keys() and len(ours) > 100
    for key, v in theirs.items():
        assert abs(ours[key] - v) <= 1e-5 * abs(v), key
    # the running max carries over from one call to the next
    calibrate(net, [torch.from_numpy(2.0 * dms)])
    bigger = flat(act_stats_to_flax(net))
    assert all(bigger[k] >= ours[k] for k in ours)
    assert any(bigger[k] > ours[k] for k in ours)


def test_bridge_rejects_stray_act_stats(trees):
    _, folded, jquant = trees
    with pytest.raises(KeyError, match="act_stats"):
        from_flax({**jquant, "act_stats": {"nope": {"amax": 1.0}}},
                  NetConfig(**SHAPE))
    with pytest.raises(KeyError, match="act_stats"):
        from_flax({**folded, "act_stats": {"stem_conv": {"amax": 1.0}}},
                  NetConfig(**SHAPE))
    assert quantized_net_config(NetConfig()).quantize


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_predictor_matches_jax(trees, calibrated):
    """The port's Predictor(quantize=True) from the unfolded float tree
    (fold, quantize, calibrate through its own crop and normalization,
    serve) against the JAX Predictor given the same int8 weights (its own
    op-by-op quantize_weights would compile once per weight shape; the
    two quantize_weights agree above)."""
    variables, _, jquant = trees
    frames, bbxs = _hand_frames(np.random.default_rng(2), 2)
    calib = (frames, bbxs) if calibrated else None
    ours = Predictor(variables, NetConfig(**SHAPE), ICVL, max_batch=2,
                     quantize=True, calibration=calib, device="cpu")
    assert ours.net_cfg.quantize and ours.net_cfg.fold_bn
    jcfg = jconfig.NetConfig(**SHAPE, fold_bn=True, quantize=True)
    with jax.disable_jit():
        theirs = JPredictor(jquant, jcfg, jconfig.CameraConfig(*ICVL),
                            max_batch=2, quantize=True, calibration=calib)
        want = theirs(frames, bbxs)
    got = ours(frames.astype(np.uint16), bbxs)
    assert got.shape == (2, 42) and np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= XYZ_ATOL_MM, err
    stats = act_stats_to_flax(ours.net)
    assert bool(stats) == calibrated
    if calibrated:
        theirs_stats = jax.tree.map(float, theirs.variables["act_stats"])
        assert stats["stem_conv"]["amax"] == theirs_stats["stem_conv"]["amax"]


# --------------------------------------------------------------------------
# the int8 forward's CUDA graph (models.int8_graph) on the CPU: it never
# engages; the card's tests are tests/test_torch_cuda_int8_graph.py
# --------------------------------------------------------------------------

def test_int8_counts_hold_the_graph_keys():
    """The graph's counters are among the int8 counters from import on,
    beside the host calls' (the benchmark copies the whole dict)."""
    from densereg_torch.models import int8_graph, layers

    assert int8_graph.int8_counts is layers.int8_counts
    assert set(layers.int8_counts) == {
        "k3_dense", "k3_implicit", "dw", "quantize", "quantize_kernel",
        "dynamic", "graph_captures", "graph_replays"}


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_graph_never_engages_on_the_cpu(trees, calibrated):
    """On the CPU the serving forward runs eagerly: no capture, no replay,
    and the answers are the eager net's, dispatch after dispatch."""
    from densereg_torch.decode import decode_poses
    from densereg_torch.models import layers

    variables, _, _ = trees
    frames, bbxs = _hand_frames(np.random.default_rng(2), 2)
    ours = Predictor(variables, NetConfig(**SHAPE), ICVL, max_batch=2,
                     quantize=True, device="cpu",
                     calibration=(frames, bbxs) if calibrated else None)
    counts = dict(layers.int8_counts)
    first, second = ours(frames, bbxs), ours(frames, bbxs)
    assert layers.int8_counts["graph_captures"] == counts["graph_captures"]
    assert layers.int8_counts["graph_replays"] == counts["graph_replays"]
    assert layers.int8_counts["quantize"] > counts["quantize"]
    mod = ours.module
    with torch.inference_mode():
        assert not mod.graph.engaged(torch.device("cpu"))
        normed, cfgs, coms = mod.normed(torch.from_numpy(frames[..., None]),
                                        torch.from_numpy(bbxs))
        want = decode_poses(*mod._subsample(ours.net(normed), normed), cfgs,
                            coms, ours.ecfg)["xyz"].numpy()
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)


def test_int8_graph_engages_only_where_it_may(trees, monkeypatch):
    """The conditions, read for a card: an int8 net, no grad recorded, no
    module calibrating, no trace; a float net never."""
    from densereg_torch.models.int8_graph import Int8ForwardGraph

    _, folded, jquant = trees
    card = torch.device("cuda")
    graph = Int8ForwardGraph(from_flax(jquant, NetConfig(**SHAPE)))
    float_graph = Int8ForwardGraph(from_flax(folded, NetConfig(
        **SHAPE, fold_bn=True)))
    with torch.inference_mode():
        assert graph.engaged(card) and not float_graph.engaged(card)
    with torch.no_grad():
        assert graph.engaged(card)
    assert not graph.engaged(card)                  # grad recorded
    with torch.inference_mode():
        graph._calibrating[3].calibrating = True
        assert not graph.engaged(card)
        graph._calibrating[3].calibrating = False
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        assert not graph.engaged(card)


def test_int8_graph_sees_a_calibration_and_a_weight_update(trees):
    """What sends a captured shape back to a capture: its stamp changes
    when ``calibrate`` replaces the activation maxima and when a weight
    changes in place, and stays put otherwise; a copy of a serving module
    (a mesh's replica) gets its own graph on its own net."""
    import copy

    from densereg_torch.models import layers
    from densereg_torch.models.int8_graph import Int8ForwardGraph

    _, _, jquant = trees
    net = from_flax(jquant, NetConfig(**SHAPE))
    dms = torch.from_numpy(seeded_depth(np.random.default_rng(5), 2, 64, 64))
    calibrate(net, [dms])
    graph = Int8ForwardGraph(net)
    with torch.inference_mode():
        net(dms)                                    # packs the weights
    stamp = graph._stamp()
    assert len(stamp) > 500 and graph._stamp() == stamp
    with torch.inference_mode():
        net(dms)
    assert graph._stamp() == stamp
    calibrate(net, [2.0 * dms])
    moved = graph._stamp()
    assert moved != stamp and graph._stamp() == moved
    conv = next(m for m in net.modules() if isinstance(m, layers.ConvBR))
    with torch.no_grad():
        conv.kernel_q.neg_()
    assert graph._stamp() != moved

    from densereg_torch.config import EvalConfig
    from densereg_torch.serving import ServingModule

    module = ServingModule(net, torch.zeros(6), EvalConfig())
    twin = copy.deepcopy(module)
    assert module.graph.net is net and twin.graph.net is twin.net
    assert twin.net is not net and len(twin.graph._stamp()) == len(stamp)


def test_exported_int8_program_is_the_eager_one(trees):
    """``torch.export`` of the int8 serving module traces the eager
    forward: the graph does not engage while it traces, the program holds
    one quantize op a standalone step of an eager forward and one K3 op a
    convolution, and it answers as the live module does."""
    from densereg_torch.models import layers

    variables, _, _ = trees
    frames, bbxs = _hand_frames(np.random.default_rng(2), 2)
    ours = Predictor(variables, NetConfig(**SHAPE), ICVL, max_batch=2,
                     quantize=True, calibration=(frames, bbxs), device="cpu")
    mod = ours.module.eval()
    args = (torch.from_numpy(frames[..., None]), torch.from_numpy(bbxs))
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x):
            seen.append(mod.graph.engaged(torch.device("cuda")))
            return x + 1

    with torch.no_grad():
        torch.export.export(Probe(), (args[1],))
        counts = dict(layers.int8_counts)
        want = mod(*args)
        steps = layers.int8_counts["quantize"] - counts["quantize"]
        convs = (layers.int8_counts["k3_dense"] + layers.int8_counts[
            "k3_implicit"] - counts["k3_dense"] - counts["k3_implicit"])
        ep = torch.export.export(mod, args)
    assert seen == [False]
    assert layers.int8_counts["graph_captures"] == counts["graph_captures"]
    targets = [str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"]
    assert targets.count("densereg.int8_quantize.default") == steps > 0
    assert sum(t in ("densereg.int8_gemm_requant.default",
                     "densereg.int8_conv_requant.default")
               for t in targets) == convs > 0
    with torch.no_grad():
        got = ep.module()(*args)
    assert torch.equal(got, want)
