"""``train.step.make_fused_train_step``: raw frames and poses to the updated
state in one callable.

On the CPU it equals the input pipeline's crop followed by ``train_step``
bit for bit: the same raw frames that ``InputPipeline`` draws, the same
generator seed, augmentation and dropout on. Against the JAX package's
fused step (augmentation off, dropout 0) both optimizers are swapped for
SGD at learning rate 1 (as ``tests/test_train.py`` does for the JAX fused
step), so the parameters move by exactly the averaged gradient, which is
held to the relative norm 5e-2 of ``tests/test_torch_train.py``; the loss
to rtol 2e-4, the moving statistics to rtol 2e-3 / atol 2e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from densereg_tpu.config import NetConfig as JNetConfig  # noqa: E402
from densereg_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402
from densereg_tpu.train import make_fused_train_step as jmake_fused  # noqa: E402
from densereg_tpu.train.state import TrainState as JTrainState  # noqa: E402

from densereg_torch.config import NetConfig, TrainConfig  # noqa: E402
from densereg_torch.data import InputPipeline, synthetic  # noqa: E402
from densereg_torch.models import init_train_variables, to_flax  # noqa: E402
from densereg_torch.train import (  # noqa: E402
    create_train_state,
    make_fused_train_step,
    train_step,
)

from test_torch_train import _flat  # noqa: E402

SHAPE = dict(num_stack=2, num_fea=8, input_hw=(32, 32))
SUB, B = 2, 3
STEPS_PER_EPOCH = 100.0


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """A synthetic split of one shard of ``SUB * B`` frames, and those raw
    frames and poses in the order ``InputPipeline(seed=0)`` draws them."""
    root = str(tmp_path_factory.mktemp("synth"))
    spec = synthetic.make_spec("training", directory=root, num_shards=1,
                               samples_per_shard=SUB * B)
    rng = np.random.default_rng(0)
    rng.permutation(1)                       # the producer's shard order
    idxs = rng.permutation(SUB * B)
    reader = spec.readers()[0]
    frames = reader["depth"][idxs][..., None]
    poses = reader["pose"][idxs].astype(np.float32)
    return spec, frames, poses


def _state(cfg, tcfg, variables):
    return create_train_state(cfg, tcfg, STEPS_PER_EPOCH,
                              variables=variables, device="cpu")


@pytest.mark.parametrize("steps", [1, 3])
def test_fused_step_equals_pipeline_and_step(raw, steps):
    spec, frames, poses = raw
    cfg = NetConfig(**SHAPE, num_joint=spec.jnt_num)
    tcfg = TrainConfig(batch_size=B, sub_batch=SUB)     # augmentation on
    variables = init_train_variables(cfg, seed=1)
    two, fused = _state(cfg, tcfg, variables), _state(cfg, tcfg, variables)
    g_two, g_fused = torch.Generator(), torch.Generator()
    g_two.manual_seed(5)
    g_fused.manual_seed(5)
    pipe = InputPipeline(spec, B, SUB, cfg.input_hw, seed=0, device="cpu")
    try:
        batch = next(iter(pipe))
    finally:
        pipe.close()
    fn = make_fused_train_step(cfg, tcfg, spec.cfg, spec.fixed_bg_threshold)
    frames_t, poses_t = torch.from_numpy(frames), torch.from_numpy(poses)
    for _ in range(steps):
        m_two = train_step(two, batch, cfg, tcfg, g_two)
        m_fused = fn(fused, frames_t, poses_t, g_fused)
        for k, v in m_two.items():
            assert torch.equal(v, m_fused[k]), k
    for (k, a), (_, b) in zip(two.net.state_dict().items(),
                              fused.net.state_dict().items()):
        assert torch.equal(a, b), k
    assert two.step == fused.step == steps
    assert torch.equal(two.renorm_t, fused.renorm_t)
    assert torch.equal(g_two.get_state(), g_fused.get_state())


@pytest.fixture(scope="module")
def jax_fused(raw):
    """The JAX package's fused step, SGD at learning rate 1, from the
    port's training init (augmentation off, dropout 0)."""
    spec, frames, poses = raw
    shape = dict(SHAPE, num_joint=spec.jnt_num, dropout_rate=0.0)
    variables = init_train_variables(NetConfig(**shape), seed=1)
    jnet = JNetConfig(**shape)
    tcfg = JTrainConfig(batch_size=B, sub_batch=SUB, augment=False)
    tx = optax.sgd(1.0)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=tx.init(params),
                        renorm_t=jnp.zeros((), jnp.float32), tx=tx,
                        apply_fn=JNet(jnet).apply)
    fn = jmake_fused(jnet, tcfg, np.asarray(tuple(spec.cfg), np.float32),
                     spec.fixed_bg_threshold, donate=False)
    new_state, metrics = fn(state, jnp.asarray(frames), jnp.asarray(poses),
                            jax.random.key(0))
    return variables, jax.device_get((new_state, metrics))


def test_fused_step_matches_jax(raw, jax_fused):
    spec, frames, poses = raw
    variables, (new_j, m_j) = jax_fused
    cfg = NetConfig(**SHAPE, num_joint=spec.jnt_num, dropout_rate=0.0)
    tcfg = TrainConfig(batch_size=B, sub_batch=SUB, augment=False)
    state = _state(cfg, tcfg, variables)
    state.optimizer = torch.optim.SGD(state.net.parameters(), lr=1.0)
    fn = make_fused_train_step(cfg, tcfg, spec.cfg, spec.fixed_bg_threshold)
    m = fn(state, torch.from_numpy(frames), torch.from_numpy(poses))
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                               rtol=2e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(m_j["grad_norm"]), rtol=1e-3)
    before = _flat(variables["params"])
    got = _flat(to_flax(state.net)["params"])
    want = _flat(new_j.params)
    assert got.keys() == want.keys()
    for path, w in want.items():
        step_j, step_t = w - before[path], got[path] - before[path]
        rel = (np.linalg.norm(step_t - step_j)
               / (np.linalg.norm(step_j) + 1e-12))
        assert rel < 5e-2, (path, rel)
    stats = _flat(to_flax(state.net)["batch_stats"])
    for path, val in _flat(new_j.batch_stats).items():
        np.testing.assert_allclose(stats[path], val, rtol=2e-3, atol=2e-5,
                                   err_msg=path)
    assert float(state.renorm_t) == float(new_j.renorm_t)
