"""The weight bridge and DenseRegNet's eval forward against the Flax net on
the same weights and inputs: s2/f16/J14 at 64 input (hourglass depth 3,
uneven SAME padding of the stem and the pools, inter-stack re-injection).

Tolerance (PARITY.md, network row): 1e-4 per element on every head of
every stack, unfolded (eval batch renorm) and folded.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402

from densereg_tpu.config import NetConfig as JNetConfig  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402
from densereg_tpu.models import fold_batch_norm as jfold  # noqa: E402

from densereg_torch.config import NetConfig  # noqa: E402
from densereg_torch.models import (  # noqa: E402
    fold_batch_norm,
    from_flax,
    init_variables,
)
from densereg_torch.models.bridge import seeded_depth  # noqa: E402

SHAPE = dict(num_stack=2, num_fea=16, num_joint=14, input_hw=(64, 64))


@pytest.fixture(scope="module")
def variables():
    return init_variables(NetConfig(**SHAPE), seed=3)


@pytest.fixture(scope="module")
def dms():
    """Normalized hand-like crops (surface in (0, 1), background -1), the
    input the heads are meant for: on it they are O(1), so 1e-4 absolute is
    about 1e-5 relative to the heads' scale."""
    return seeded_depth(np.random.default_rng(5), 2, 64, 64)


def _flax_heads(variables, dms, fold_bn):
    net = JNet(JNetConfig(**SHAPE, fold_bn=fold_bn))
    out = jax.jit(lambda v, x: net.apply(v, x, train=False))(variables, dms)
    return jax.tree.map(np.asarray, out)


def _compare(net, variables, dms, fold_bn):
    with torch.inference_mode():
        got = net(torch.from_numpy(dms))
    want = _flax_heads(variables, dms, fold_bn)
    for key in ("hm", "hm3", "um"):
        assert len(got[key]) == 2
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape and g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)


def test_unfolded_forward_matches_flax(variables, dms):
    net = from_flax(variables, NetConfig(**SHAPE))
    assert not net.cfg.fold_bn
    _compare(net, variables, dms, fold_bn=False)


def test_folded_forward_matches_flax(variables, dms):
    folded = fold_batch_norm(variables)
    for a, b in zip(jax.tree.leaves(folded), jax.tree.leaves(jfold(variables))):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)
    net = from_flax(folded, NetConfig(**SHAPE))
    assert net.cfg.fold_bn
    _compare(net, folded, dms, fold_bn=True)


def test_init_variables_is_a_flax_tree(variables, dms):
    """init_variables yields exactly the Flax net's tree (names and shapes)
    and O(1) heads, not the ties a near-zero init decodes to."""
    net = JNet(JNetConfig(**SHAPE))
    ref = jax.eval_shape(lambda: net.init(jax.random.key(0), dms, train=False))
    shapes = lambda t: sorted(
        (jax.tree_util.keystr(p), tuple(a.shape))
        for p, a in jax.tree_util.tree_flatten_with_path(t)[0])
    assert shapes(variables) == shapes(dict(ref))
    heads = _flax_heads(variables, dms, fold_bn=False)
    for key in ("hm", "hm3", "um"):
        assert 0.1 < heads[key][-1].std() < 100.0


def test_bridge_rejects_missing_and_extra_keys(variables):
    cfg = NetConfig(**SHAPE)
    params = dict(variables["params"])
    del params["um_head_s1"]
    with pytest.raises(KeyError, match="missing .*um_head_s1"):
        from_flax({**variables, "params": params}, cfg)
    params = {**variables["params"], "extra_conv": {"conv": {
        "kernel": np.zeros((1, 1, 2, 2), np.float32)}}}
    with pytest.raises(KeyError, match="left over .*extra_conv"):
        from_flax({**variables, "params": params}, cfg)
    stats = {**variables["batch_stats"]}
    del stats["stem_conv"]
    with pytest.raises(KeyError, match="missing .*stem_conv.bn"):
        from_flax({**variables, "batch_stats": stats}, cfg)
