"""The network variants ``um_v1_lite`` (depthwise middle convolutions) and
``um_v1_deconv`` (learned stride-2 transposed-convolution upsampling) in
the port against the JAX package, on the CPU: s1/f8/J16 at 64 input
(hourglass depth 3), from the same seeded numpy weights and inputs.

Tolerances: heads 1e-4 per element (PARITY.md, network row), unfolded and
folded. The int8 nets against the JAX int8 net run op by op
(``jax.disable_jit``, as ``tests/test_torch_int8.py`` explains): heads
1e-4, the calibration statistics 1e-5 relative. xyz 0.02 mm (PARITY.md,
decode row). At two stacks (s2/f8) the folded lite heads differ from Flax
by 1.7e-4 on an um element of magnitude 6, where each package is
0.5e-4-1.5e-4 from a float64 run of the same net: float32 rounding that the
inter-stack re-injection amplifies, so these tests hold one stack, as
``tests/test_torch_variants_deep.py`` does at depths 5 and 6.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from flax import serialization  # noqa: E402

from densereg_tpu import config as jconfig  # noqa: E402
from densereg_tpu.convert import save_converted as jsave_converted  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402
from densereg_tpu.models import fold_batch_norm as jfold  # noqa: E402
from densereg_tpu.models.quantize import (  # noqa: E402
    calibrate as jcalibrate,
    quantize_weights as jquantize_weights,
)
from densereg_tpu.serving import Predictor as JPredictor  # noqa: E402

from densereg_torch import NetConfig, Predictor  # noqa: E402
from densereg_torch import convert as tconvert  # noqa: E402
from densereg_torch.config import TrainConfig, model_desc  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.eval import read_result_file  # noqa: E402
from densereg_torch.models import (  # noqa: E402
    act_stats_to_flax,
    calibrate,
    fold_batch_norm,
    from_flax,
    init_variables,
    quantize_weights,
    to_flax,
)
from densereg_torch.models.bridge import seeded_depth  # noqa: E402
from densereg_torch.models.layers import ConvBR, Residual  # noqa: E402
from densereg_torch.models.ops import Deconv  # noqa: E402
from densereg_torch.train import loop as tloop  # noqa: E402
from test_torch_serving import ICVL, _hand_frames  # noqa: E402

SHAPE = dict(num_stack=1, num_fea=8, num_joint=16, input_hw=(64, 64))
VARIANTS = ("um_v1_lite", "um_v1_deconv")
HEAD_TOL = 1e-4
XYZ_ATOL_MM = 0.02


def _cfg(module, **kw):
    return NetConfig(**SHAPE, net_module=module, **kw)


def _jcfg(module, **kw):
    return jconfig.NetConfig(**SHAPE, net_module=module, **kw)


@pytest.fixture(scope="module")
def trees():
    return {m: init_variables(_cfg(m), seed=3) for m in VARIANTS}


@pytest.fixture(scope="module")
def dms():
    return seeded_depth(np.random.default_rng(5), 2, 64, 64)


def _heads_match(got, want):
    for key in ("hm", "hm3", "um"):
        assert len(got[key]) == len(want[key]) == SHAPE["num_stack"]
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=HEAD_TOL)


@pytest.mark.parametrize("fold", [False, True], ids=["unfolded", "folded"])
@pytest.mark.parametrize("module", VARIANTS)
def test_heads_match_flax(trees, dms, module, fold):
    variables = trees[module]
    if fold:
        variables = fold_batch_norm(variables)
        for a, b in zip(jax.tree.leaves(variables),
                        jax.tree.leaves(jfold(trees[module]))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    net = from_flax(variables, _cfg(module))
    assert net.cfg.fold_bn == fold and net.cfg.net_module == module
    with torch.inference_mode():
        got = net(torch.from_numpy(dms))
    jnet = JNet(_jcfg(module, fold_bn=fold))
    _heads_match(got, jax.jit(lambda v, x: jnet.apply(v, x, train=False))(
        variables, dms))


@pytest.mark.parametrize("module", VARIANTS)
def test_init_variables_is_a_flax_tree(trees, dms, module):
    """The variant's modules: a depthwise conv2 in every bottleneck (lite)
    or one ``deconv_up`` a level (deconv), and ``init_variables`` gives
    exactly the Flax net's tree, with O(1) heads."""
    jnet = JNet(_jcfg(module))
    ref = jax.eval_shape(lambda: jnet.init(jax.random.key(0), dms,
                                           train=False))
    shapes = lambda t: sorted(
        (jax.tree_util.keystr(p), tuple(a.shape))
        for p, a in jax.tree_util.tree_flatten_with_path(t)[0])
    assert shapes(trees[module]) == shapes(dict(ref))
    net = from_flax(trees[module], _cfg(module))
    res = [m for m in net.modules() if isinstance(m, Residual)]
    groups = [m.conv2.conv.groups for m in res]
    deconvs = [m for m in net.modules() if isinstance(m, Deconv)]
    if module == "um_v1_lite":
        assert groups == [m.conv1.conv.kernel.shape[0] for m in res]
        assert not deconvs
    else:
        assert set(groups) == {1}
        assert len(deconvs) == _cfg(module).hourglass_depth
    with torch.inference_mode():
        heads = net(torch.from_numpy(dms))
    for key in ("hm", "hm3", "um"):
        assert 0.1 < float(heads[key][-1].std()) < 100.0


def test_net_module_is_checked():
    with pytest.raises(ValueError, match="net_module"):
        NetConfig(net_module="um_v2")


@pytest.mark.parametrize("module", VARIANTS)
def test_bridge_and_payload_round_trip(trees, module, tmp_path):
    """``to_flax(from_flax(v)) == v`` leaf for leaf, unfolded and folded;
    the converted payload is byte for byte the JAX package's and Flax's,
    and reads back as the tree."""
    for variables in (trees[module], fold_batch_norm(trees[module])):
        back = to_flax(from_flax(variables, _cfg(module)))
        flat = lambda t: {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                          jax.tree_util.tree_flatten_with_path(t)[0]}
        assert flat(back).keys() == flat(variables).keys()
        for key, a in flat(variables).items():
            np.testing.assert_array_equal(flat(back)[key], a, err_msg=key)
    payload = {**trees[module], "renorm_t": np.float32(7.5)}
    assert tconvert.packb(payload) == serialization.msgpack_serialize(payload)
    jsave_converted(payload, str(tmp_path / "jax.msgpack"))
    tconvert.save_converted(payload, str(tmp_path / "torch.msgpack"))
    assert ((tmp_path / "jax.msgpack").read_bytes()
            == (tmp_path / "torch.msgpack").read_bytes())
    loaded = tconvert.load_converted(str(tmp_path / "torch.msgpack"))
    assert float(loaded["renorm_t"]) == 7.5
    net = from_flax({k: loaded[k] for k in ("params", "batch_stats")},
                    _cfg(module))
    assert sum(p.numel() for p in net.parameters()) == sum(
        a.size for a in jax.tree.leaves(trees[module]["params"]))


@pytest.fixture(scope="module")
def int8_trees(trees):
    """Both packages' int8 weights (the port's quantize_weights against the
    JAX one, jitted: op by op it compiles once per weight shape)."""
    out = {}
    for m in VARIANTS:
        folded = fold_batch_norm(trees[m])
        jquant = jax.tree.map(np.asarray, jax.jit(jquantize_weights)(
            jfold(trees[m])))
        out[m] = (quantize_weights(folded), jquant)
    return out


def test_quantize_weights_matches_jax(int8_trees):
    """Depthwise kernels quantized per output channel over (h, w, 1); the
    transposed convolution stays float, as in JAX."""
    flat = lambda t: {jax.tree_util.keystr(p): np.asarray(a) for p, a in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    for m, (ours, theirs) in int8_trees.items():
        ours, theirs = flat(ours), flat(theirs)
        assert ours.keys() == theirs.keys()
        for key, a in ours.items():
            b = theirs[key]
            assert a.dtype == b.dtype and a.shape == b.shape, key
            if a.dtype == np.int8:
                np.testing.assert_array_equal(a, b, err_msg=key)
            else:
                assert (np.abs(a - b) <= np.spacing(np.abs(b))).all(), key
        if m == "um_v1_lite":
            assert ours["['params']['hg_s0']['upper']['conv2']['kernel_q']"
                        ].shape == (3, 3, 1, 4)
        else:
            assert ours["['params']['hg_s0']['deconv_up']['ConvTranspose_0']"
                        "['kernel']"].dtype == np.float32


@pytest.fixture(scope="module")
def jax_int8(int8_trees, dms):
    """The JAX int8 nets op by op: lite dynamic, calibrated statistics and
    calibrated heads; deconv dynamic."""
    out = {}
    with jax.disable_jit():
        jq = int8_trees["um_v1_lite"][1]
        net = JNet(_jcfg("um_v1_lite", fold_bn=True, quantize=True))
        out["lite_dynamic"] = net.apply(jq, jnp.asarray(dms), train=False)
        cal = jcalibrate(net, jq, [jnp.asarray(dms)])
        out["lite_stats"] = cal["act_stats"]
        out["lite_calibrated"] = net.apply(cal, jnp.asarray(dms),
                                           train=False)
        jq = int8_trees["um_v1_deconv"][1]
        net = JNet(_jcfg("um_v1_deconv", fold_bn=True, quantize=True))
        out["deconv_dynamic"] = net.apply(jq, jnp.asarray(dms), train=False)
    return jax.tree.map(np.asarray, out)


@pytest.mark.parametrize("mode", ["lite_dynamic", "lite_calibrated",
                                  "deconv_dynamic"])
def test_int8_net_matches_jax(int8_trees, jax_int8, dms, mode):
    """Every depthwise convolution on the depthwise kernel's plain version
    (calibrated: its input is conv1's QTensor); the deconv net's
    ``Deconv`` in float on the float view."""
    module = "um_v1_lite" if mode.startswith("lite") else "um_v1_deconv"
    variables = dict(int8_trees[module][1])
    if mode == "lite_calibrated":
        variables["act_stats"] = jax_int8["lite_stats"]
    net = from_flax(variables, _cfg(module))
    assert net.cfg.quantize
    with torch.inference_mode():
        got = net(torch.from_numpy(dms))
    _heads_match(got, jax_int8[mode])


def test_calibrate_lite_matches_jax(int8_trees, jax_int8, dms):
    net = from_flax(int8_trees["um_v1_lite"][0], _cfg("um_v1_lite"))
    calibrate(net, [torch.from_numpy(dms)])
    flat = lambda t: {jax.tree_util.keystr(p): float(a) for p, a in
                      jax.tree_util.tree_flatten_with_path(t)[0]}
    ours, theirs = flat(act_stats_to_flax(net)), flat(jax_int8["lite_stats"])
    assert ours.keys() == theirs.keys() and len(ours) > 40
    for key, v in theirs.items():
        assert abs(ours[key] - v) <= 1e-5 * abs(v), key


def test_calibrated_deconv_is_refused_where_jax_crashes(int8_trees, dms):
    """The JAX package's calibrated int8 ``um_v1_deconv`` crashes when the
    transposed convolution meets a QTensor; the port refuses it with a
    ``NotImplementedError`` that names the spot, wherever it learns the
    net is calibrated, and builds nothing the JAX package lacks."""
    ours, jq = int8_trees["um_v1_deconv"]
    net = JNet(_jcfg("um_v1_deconv", fold_bn=True, quantize=True))
    with pytest.raises(TypeError, match="QTensor"):
        with jax.disable_jit():
            jcalibrate(net, jq, [jnp.asarray(dms)])
    where = "densereg_tpu/models/hourglass.py:93"
    with pytest.raises(NotImplementedError, match=where):
        calibrate(from_flax(ours, _cfg("um_v1_deconv")),
                  [torch.from_numpy(dms)])
    lite = from_flax(int8_trees["um_v1_lite"][0], _cfg("um_v1_lite"))
    stats = act_stats_to_flax(calibrate(lite, [torch.from_numpy(dms)]))
    with pytest.raises(NotImplementedError, match=where):
        from_flax({**ours, "act_stats": {"stem_conv": stats["stem_conv"]}},
                  _cfg("um_v1_deconv"))
    frames, bbxs = _hand_frames(np.random.default_rng(2), 2)
    with pytest.raises(NotImplementedError, match=where):
        Predictor(ours, _cfg("um_v1_deconv"), ICVL, max_batch=2,
                  quantize=True, calibration=(frames, bbxs), device="cpu")


@pytest.mark.parametrize("module", VARIANTS)
def test_predictor_matches_jax(trees, module):
    """Float32 serving of uint16 frames with boxes, the port's CPU
    Predictor against the JAX Predictor on the same weights; and the int8
    predictors (lite calibrated and dynamic, deconv dynamic) serve finite
    joints, the lite int8 depthwise convolutions counted in its net."""
    frames, bbxs = _hand_frames(np.random.default_rng(2), 3)
    ours = Predictor(trees[module], _cfg(module), ICVL, max_batch=2,
                     device="cpu")
    theirs = JPredictor(trees[module], _jcfg(module),
                        jconfig.CameraConfig(*ICVL), max_batch=2)
    got = ours(frames.astype(np.uint16), bbxs)
    want = theirs(frames, bbxs)
    assert got.shape == (3, 48)
    assert np.abs(got - want).max() <= XYZ_ATOL_MM
    modes = ([dict(calibration=(frames, bbxs)), {}] if module == "um_v1_lite"
             else [{}])
    for kw in modes:
        pred = Predictor(trees[module], _cfg(module), ICVL, max_batch=2,
                         quantize=True, device="cpu", **kw)
        assert np.isfinite(pred(frames, bbxs)).all()
        dw = [m for m in pred.net.modules()
              if isinstance(m, ConvBR) and m.depthwise]
        n_res = sum(isinstance(m, Residual) for m in pred.net.modules())
        assert len(dw) == (n_res if module == "um_v1_lite" else 0)


@pytest.mark.parametrize("module", VARIANTS)
def test_test_driver_runs_the_variant(trees, module, tmp_path):
    """``train.loop.test`` on a converted payload of the variant: the run
    named by ``model_desc(..., net_name)``, one result line a frame in
    shard order; and ``Predictor.from_converted`` serves the payload as
    the variables."""
    payload = str(tmp_path / "params.msgpack")
    tconvert.save_converted({**trees[module], "renorm_t": 0.0}, payload)
    spec = synthetic.make_spec("testing", directory=str(tmp_path / "synth"),
                               num_shards=1, samples_per_shard=6)
    cfg = _cfg(module)
    report = tloop.test(spec, cfg, TrainConfig(base_dir=str(tmp_path)),
                        init_params=payload, net_name=module, device="cpu",
                        log_fn=lambda *_: None)
    assert report["num_frames"] == 6
    run = os.path.join(str(tmp_path), model_desc(
        spec.name, "training", cfg, True, module))
    assert run.endswith("_" + module)
    (res,) = [f for f in os.listdir(run) if f.endswith("-result.txt")]
    names, xyz = read_result_file(os.path.join(run, res))
    assert len(names) == 6 and xyz.shape == (6, 48)
    assert np.isfinite(xyz).all()
    frames, bbxs = _hand_frames(np.random.default_rng(4), 2)
    np.testing.assert_array_equal(
        Predictor.from_converted(payload, cfg, ICVL, max_batch=2,
                                 device="cpu")(frames, bbxs),
        Predictor(trees[module], cfg, ICVL, max_batch=2,
                  device="cpu")(frames, bbxs))
