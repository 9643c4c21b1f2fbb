"""The port's training pieces against the JAX package on the same weights
and inputs: batch renorm's training form, the renorm schedule, the losses,
the learning rate, the weight decay, ``loss_fn``, one accumulated train
step, Adam on one gradient tree and the training init; then the port alone:
dropout, an overfit run and seeded determinism.

The JAX side is compiled once per program for the file (module fixtures);
its train state is built from the port's numpy init, not by ``net.init``.
"""


import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from densereg_tpu.config import NetConfig as JNetConfig  # noqa: E402
from densereg_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402
from densereg_tpu.models import renorm_clip_schedule as jschedule  # noqa: E402
from densereg_tpu.models.layers import BatchRenorm as JBatchRenorm  # noqa: E402
from densereg_tpu.models.layers import ConvBR as JConvBR  # noqa: E402
from densereg_tpu.train import losses as jlosses  # noqa: E402
from densereg_tpu.train.lr import staircase_exponential_decay as jlr  # noqa: E402
from densereg_tpu.train.state import TrainState as JTrainState  # noqa: E402
from densereg_tpu.train.state import loss_fn as jloss_fn  # noqa: E402
from densereg_tpu.train.state import make_optimizer as jmake_optimizer  # noqa: E402
from densereg_tpu.train.state import weight_decay_loss as jwd  # noqa: E402
from densereg_tpu.train.step import make_train_step  # noqa: E402

from densereg_torch.config import NetConfig, TrainConfig  # noqa: E402
from densereg_torch.models import (  # noqa: E402
    from_flax,
    init_train_variables,
    renorm_clip_schedule,
    to_flax,
)
from densereg_torch.models.bridge import flax_tree  # noqa: E402
from densereg_torch.models.hourglass import dropout  # noqa: E402
from densereg_torch.models.layers import BatchRenorm  # noqa: E402
from densereg_torch.train import (  # noqa: E402
    create_train_state,
    loss_fn,
    losses,
    make_optimizer,
    staircase_exponential_decay,
    train_step,
    weight_decay_loss,
)

SHAPE = dict(num_stack=2, num_fea=8, num_joint=3, input_hw=(32, 32))
NET = NetConfig(**SHAPE, dropout_rate=0.0)
JNET = JNetConfig(**SHAPE, dropout_rate=0.0)
TCFG = dict(batch_size=4, sub_batch=2, augment=False)
STEPS_PER_EPOCH = 100.0
ICVL = (241.42, 241.42, 160.0, 120.0, 320.0, 240.0)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def make_batch(rng, sub, b, j=3, hw=32):
    """Micro-batches of raw-mm crops near 400 mm with a quarter of the
    pixels background (0 mm), poses around them, the crop intrinsics of a
    32x32 input (``tests/test_train.py``'s batch with a background: without
    one, every path from the inter-stack biases meets a renorm that removes
    a per-channel constant, and their gradients are rounding noise)."""
    s = hw / 320.0, hw / 240.0
    cfg = np.array([ICVL[0] * s[0], ICVL[1] * s[1], ICVL[2] * s[0],
                    ICVL[3] * s[1], hw, hw], np.float32)
    poses = np.zeros((sub, b, j, 3), np.float32)
    poses[..., 0] = rng.uniform(-30, 30, (sub, b, j))
    poses[..., 1] = rng.uniform(-30, 30, (sub, b, j))
    poses[..., 2] = rng.uniform(380, 420, (sub, b, j))
    dm = rng.uniform(350, 450, (sub, b, hw, hw, 1)).astype(np.float32)
    dm[rng.random(dm.shape) < 0.25] = 0.0
    return {"dm": dm,
            "pose": poses.reshape(sub, b, -1),
            "cfg": np.tile(cfg, (sub, b, 1)),
            "com": poses.mean(axis=2)}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def variables():
    return init_train_variables(NET, seed=4)


@pytest.fixture(scope="module")
def batch():
    return make_batch(np.random.default_rng(8), TCFG["sub_batch"],
                      TCFG["batch_size"])


def _jax_state(variables, tcfg):
    tx = jmake_optimizer(tcfg, STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray,
                                                variables["batch_stats"]),
                       opt_state=tx.init(params),
                       renorm_t=jnp.zeros((), jnp.float32), tx=tx,
                       apply_fn=JNet(JNET).apply)


@pytest.fixture(scope="module")
def jax_step(variables, batch):
    """One JAX train step (with the averaged gradient) and its inputs."""
    tcfg = JTrainConfig(**TCFG)
    state = _jax_state(variables, tcfg)
    step = make_train_step(JNET, tcfg, donate=False, with_grads=True)
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, batch),
                              jax.random.key(0))
    return jax.device_get((new_state, metrics))


# --------------------------------------------------------------------------
# batch renorm, schedule, losses, learning rate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("t", [0.0, 0.5])
def test_batch_renorm_training_form_matches_flax(t):
    rng = np.random.default_rng(int(t * 10) + 1)
    c = 6
    x = rng.normal(0.3, 1.7, (4, 5, 7, c)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    params = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "beta": rng.normal(0, 0.3, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
             "var": rng.uniform(0.3, 4.0, c).astype(np.float32)}
    r_max, d_max = jschedule(t)
    mod = JBatchRenorm()

    def fn(x, params):
        y, mut = mod.apply({"params": params, "batch_stats": stats}, x,
                           train=True, r_max=r_max, d_max=d_max,
                           mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (y_j, stats_j)), (gx_j, gp_j) = jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True)(x, params)

    bn = BatchRenorm(c).train()
    with torch.no_grad():
        bn.gamma.copy_(torch.from_numpy(params["gamma"]))
        bn.beta.copy_(torch.from_numpy(params["beta"]))
        bn.mean.copy_(torch.from_numpy(stats["mean"]))
        bn.var.copy_(torch.from_numpy(stats["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = bn(xt, *renorm_clip_schedule(t))
    (y * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()

    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), y_j,
                               rtol=1e-5, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(), stats_j[k],
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx_j,
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(bn.gamma.grad.numpy(), gp_j["gamma"],
                               rtol=1e-4)
    np.testing.assert_allclose(bn.beta.grad.numpy(), gp_j["beta"], rtol=1e-4)
    if t > 0:       # r and d clipped somewhere, so the schedule mattered
        assert not np.allclose(y_j, JBatchRenorm().apply(
            {"params": params, "batch_stats": stats}, x, train=True,
            mutable=["batch_stats"])[0])


def test_renorm_schedule_and_losses_match_jax():
    for t in (0.0, 1e-5, 0.5, 3.0):
        np.testing.assert_allclose(renorm_clip_schedule(t),
                                   [float(v) for v in jschedule(t)],
                                   rtol=1e-6, atol=0)
    x = np.random.default_rng(2).normal(size=(3, 4, 5)).astype(np.float32)
    logits, labels = x[0], np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]
    xt = torch.from_numpy(x)
    pairs = [
        (losses.l2_loss(xt, 0.3), jlosses.l2_loss(x, 0.3)),
        (losses.l1_loss(xt, 0.3), jlosses.l1_loss(x, 0.3)),
        (losses.l1_regularizer(0.2)(xt), jlosses.l1_regularizer(0.2)(x)),
        (losses.l2_regularizer(0.2)(xt), jlosses.l2_regularizer(0.2)(x)),
        (losses.l1_l2_regularizer(0.2, 0.7)(xt),
         jlosses.l1_l2_regularizer(0.2, 0.7)(x)),
        (losses.cross_entropy_loss(torch.from_numpy(logits),
                                   torch.from_numpy(labels), 0.1, 2.0),
         jlosses.cross_entropy_loss(logits, labels, 0.1, 2.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_learning_rate_matches_optax():
    d = 7
    ours = staircase_exponential_decay(1e-3, d, 0.1)
    theirs = jlr(1e-3, d, 0.1)
    for count in (0, d - 1, d, 3 * d):
        np.testing.assert_allclose(ours(count), float(theirs(count)),
                                   rtol=1e-6)
    assert ours(0) == 1e-3 and ours(d) == pytest.approx(1e-4)


def test_weight_decay_matches_jax_and_skips_inter(variables):
    net = from_flax(variables, NET)
    got = weight_decay_loss(net, 5e-4).item()
    np.testing.assert_allclose(got, float(jwd(variables["params"], 5e-4)),
                               rtol=1e-6)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.startswith("inter_"):
                p.mul_(100.0)
            elif not name.endswith(".kernel"):
                p.add_(100.0)            # biases, gamma, beta: exempt
    assert weight_decay_loss(net, 5e-4).item() == pytest.approx(got,
                                                                rel=1e-6)
    assert any(n.startswith("inter_") for n, _ in net.named_parameters())


# --------------------------------------------------------------------------
# loss_fn and one accumulated step
# --------------------------------------------------------------------------

def test_loss_fn_components_match_jax(variables, batch):
    mb = {k: v[0] for k, v in batch.items()}
    tcfg = JTrainConfig(**TCFG)
    want = jax.jit(lambda p, s, b: jloss_fn(
        p, s, JNet(JNET).apply, b, net_cfg=JNET, tcfg=tcfg,
        renorm_t=jnp.float32(0.5), dropout_rng=jax.random.key(0))[1])(
        variables["params"], variables["batch_stats"], mb)
    stats_j, m_j = jax.device_get(want)

    net = from_flax(variables, NET).train()
    _, m = loss_fn(net, _torch_batch(mb), NET, TrainConfig(**TCFG),
                   torch.tensor(0.5))
    for k in ("loss", "hm_loss", "hm3_loss", "um_loss", "reg_loss"):
        np.testing.assert_allclose(float(m[k]), float(m_j[k]), rtol=1e-5,
                                   err_msg=k)
    got = _flat(flax_tree({k: v for k, v in net.state_dict().items()
                           if k.endswith((".mean", ".var"))}))
    for path, val in _flat(stats_j).items():
        np.testing.assert_allclose(got[path], val, rtol=2e-3, atol=2e-5,
                                   err_msg=path)


def test_train_step_matches_jax(variables, batch, jax_step):
    """One step, batch 4 x sub_batch 2, augmentation off, dropout 0: the
    loss, every parameter's averaged gradient (before the clip), the moving
    statistics and the schedule clock. Gradients are compared directly,
    not through Adam's first step, which turns the sign of a near-zero
    gradient into +-lr. Relative norm 5e-2: the float32 reduction-order
    noise floor through the renorm backward (tests/test_parallel.py)."""
    new_j, m_j = jax_step
    state = create_train_state(NET, TrainConfig(**TCFG), STEPS_PER_EPOCH,
                               variables=variables, device="cpu")
    m = train_step(state, _torch_batch(batch), NET, TrainConfig(**TCFG),
                   with_grads=True)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                               rtol=2e-4)
    grads = _flat(flax_tree(m["grads"]))
    want = _flat(m_j["grads"])
    assert grads.keys() == want.keys()
    for path, g in want.items():
        rel = np.linalg.norm(grads[path] - g) / (np.linalg.norm(g) + 1e-12)
        assert rel < 5e-2, (path, rel)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-3)
    stats = _flat(to_flax(state.net)["batch_stats"])
    for path, val in _flat(new_j.batch_stats).items():
        np.testing.assert_allclose(stats[path], val, rtol=2e-3, atol=2e-5,
                                   err_msg=path)
    assert state.renorm_t.dtype == torch.float32
    assert float(state.renorm_t) == float(new_j.renorm_t)
    assert state.step == int(new_j.step) == 1


def test_adam_matches_optax_on_one_gradient_tree():
    """The clip and Adam on the same gradients, over a learning-rate
    decay boundary (decay every 2 updates)."""
    rng = np.random.default_rng(3)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 0.3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(4)]
    tcfg = dict(epochs_per_decay=1, init_lr=1e-2)
    tx = jmake_optimizer(JTrainConfig(**tcfg), 2.0)
    p_j, opt_j = dict(params), tx.init(params)
    p_t = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
           for k, v in params.items()}
    opt = make_optimizer(list(p_t.values()), TrainConfig(**tcfg), 2.0)
    for g in grads:
        upd, opt_j = tx.update(g, opt_j, p_j)
        p_j = {k: p_j[k] + upd[k] for k in p_j}
        for k, p in p_t.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in params:
            np.testing.assert_allclose(p_t[k].detach().numpy(),
                                       np.asarray(p_j[k]), rtol=1e-6,
                                       atol=1e-9)
    assert opt.count == 4


def test_training_init_matches_flax_distribution(variables):
    """Kernels: a standard normal truncated to [-2, 2] times 0.01 (std
    0.0088), against Flax's draw for a ConvBR kernel; the rest 0 and 1."""
    x = jnp.zeros((1, 8, 8, 64), jnp.float32)
    flax_k = np.asarray(JConvBR(256, (3, 3)).init(
        jax.random.key(0), x, train=False)["params"]["conv"]["kernel"])
    ours = np.concatenate([v.ravel() for k, v in
                           _flat(variables["params"]).items()
                           if k.endswith("/kernel")])
    assert abs(ours.std() / flax_k.std() - 1.0) < 0.03
    assert np.abs(ours).max() <= 0.02 and np.abs(flax_k).max() <= 0.02
    for path, v in _flat(variables["params"]).items():
        if path.endswith(("/bias", "/beta")):
            assert not v.any(), path
        elif path.endswith("/gamma"):
            assert (v == 1).all(), path
    for path, v in _flat(variables["batch_stats"]).items():
        assert (v == (1.0 if path.endswith("/var") else 0.0)).all(), path


def test_to_flax_round_trips(variables):
    """``to_flax`` is the inverse of ``from_flax``: the same tree, leaf for
    leaf and bit for bit, unfolded and folded (Flax layout, HWIO)."""
    from densereg_torch.models import fold_batch_norm

    for tree in (variables, fold_batch_norm(variables)):
        back = to_flax(from_flax(tree, NET))
        assert back.keys() == tree.keys()
        for col in tree:
            a, b = _flat(tree[col]), _flat(back[col])
            assert a.keys() == b.keys()
            for path in a:
                np.testing.assert_array_equal(a[path], b[path], err_msg=path)


# --------------------------------------------------------------------------
# the port alone
# --------------------------------------------------------------------------

def test_dropout_keeps_and_scales():
    x = torch.ones(200, 100)
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.5, g)
    kept = y != 0
    assert 0.45 < kept.float().mean().item() < 0.55
    assert torch.all(y[kept] == 2.0)
    assert torch.equal(y, dropout(x, 0.5, torch.Generator().manual_seed(0)))
    assert dropout(x, 0.0, g) is x

    net = from_flax(init_train_variables(NetConfig(**SHAPE), 1),
                    NetConfig(**SHAPE))
    dms = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (2, 32, 32, 1)).astype(np.float32))
    with torch.no_grad():
        net.eval()
        a, b = net(dms)["um"][-1], net(dms)["um"][-1]
        assert torch.equal(a, b)                    # eval: no dropout
        net.train()
        # no r_max: the outputs do not read the moving statistics, which
        # each training forward moves
        run = lambda s: net(dms, generator=torch.Generator().manual_seed(
            s))["um"][-1]
        assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def test_overfits_a_tiny_batch():
    net_cfg = NetConfig(num_stack=1, num_fea=8, num_joint=3,
                        input_hw=(32, 32))
    tcfg = TrainConfig(batch_size=2, sub_batch=1, augment=False, init_lr=3e-3)
    state = create_train_state(net_cfg, tcfg, 1e6, device="cpu")
    batch = _torch_batch(make_batch(np.random.default_rng(0), 1, 2))
    g = torch.Generator().manual_seed(0)
    losses_ = [float(train_step(state, batch, net_cfg, tcfg, g)["loss"])
               for _ in range(30)]
    assert losses_[-1] < 0.5 * losses_[0], losses_[::6]


def test_two_seeded_runs_are_identical():
    net_cfg = NetConfig(num_stack=1, num_fea=8, num_joint=3,
                        input_hw=(32, 32))
    tcfg = TrainConfig(batch_size=2, sub_batch=2, ema_decay=0.9)
    batch = _torch_batch(make_batch(np.random.default_rng(1), 2, 2))

    def run():
        state = create_train_state(net_cfg, tcfg, 10.0, device="cpu")
        g = torch.Generator().manual_seed(5)
        out = [train_step(state, batch, net_cfg, tcfg, g)["loss"]
               for _ in range(3)]
        return out, state

    (l1, s1), (l2, s2) = run(), run()
    assert [float(v) for v in l1] == [float(v) for v in l2]
    for (k, a), b in zip(s1.net.state_dict().items(),
                         s2.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(torch.equal(s1.ema[k], s2.ema[k]) for k in s1.ema)
    assert tcfg.augment and net_cfg.dropout_rate > 0   # both drawn from g
