"""``NetConfig.remat``: the training forward rematerialised with
``torch.utils.checkpoint`` must change what the step keeps, nothing that it
computes.

On the CPU the port's remat step equals its plain step bit for bit: the
loss, every averaged gradient, the moving statistics and the dropout
generator's state, with dropout 0 and 0.3 (the JAX package's
``tests/test_train.py::test_remat_matches_no_remat`` holds it to rtol 1e-5
with dropout 0). Against the JAX remat step the tolerances are those
``tests/test_torch_train.py`` holds a step to: loss rtol 2e-4, each
gradient within relative norm 5e-2, moving statistics rtol 2e-3 / atol
2e-5.
"""

import dataclasses
import json
import os

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
from densereg_tpu.train.state import TrainState as JTrainState  # noqa: E402
from densereg_tpu.train.state import make_optimizer as jmake_optimizer  # noqa: E402
from densereg_tpu.train.step import make_train_step  # noqa: E402

from densereg_torch.config import NetConfig, TrainConfig  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.models import init_train_variables, to_flax  # noqa: E402
from densereg_torch.models.bridge import flax_tree  # noqa: E402
from densereg_torch.train import create_train_state, train, train_step  # noqa: E402

from test_torch_train import _flat, _torch_batch, make_batch  # noqa: E402

SHAPE = dict(num_stack=1, num_fea=8, num_joint=3, input_hw=(32, 32))
TCFG = dict(batch_size=4, sub_batch=2)
STEPS_PER_EPOCH = 100.0


@pytest.fixture(scope="module")
def batch():
    return make_batch(np.random.default_rng(8), TCFG["sub_batch"],
                      TCFG["batch_size"])


def _step(cfg: NetConfig, tcfg: TrainConfig, variables, batch, seed=3):
    """One port step from ``variables`` on the CPU; returns the metrics,
    the net's state dict, the generator's state and how many times the
    net's stem ran."""
    state = create_train_state(cfg, tcfg, STEPS_PER_EPOCH,
                               variables=variables, device="cpu")
    calls = []
    state.net.stem_conv.register_forward_hook(lambda *_: calls.append(1))
    gen = torch.Generator()
    gen.manual_seed(seed)
    m = train_step(state, _torch_batch(batch), cfg, tcfg, gen,
                   with_grads=True)
    return m, state.net.state_dict(), gen.get_state(), len(calls)


@pytest.mark.parametrize("module", ["um_v1", "um_v1_lite", "um_v1_deconv"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_remat_step_equals_plain_step(batch, rate, module):
    """Augmentation on, so that the generator draws the warp and the
    dropout masks of both micro steps: the recompute must draw the same
    masks again and leave the generator where the plain step does."""
    base = NetConfig(**SHAPE, dropout_rate=rate, net_module=module)
    tcfg = TrainConfig(**TCFG, augment=True)
    variables = init_train_variables(base, seed=4)
    m0, s0, g0, n0 = _step(base, tcfg, variables, batch)
    m1, s1, g1, n1 = _step(dataclasses.replace(base, remat=True), tcfg,
                           variables, batch)
    sub = TCFG["sub_batch"]
    assert (n0, n1) == (sub, 2 * sub)      # the backward ran the forward
    for k in ("loss", "hm_loss", "hm3_loss", "um_loss", "reg_loss",
              "grad_norm", "param_norm"):
        assert float(m0[k]) == float(m1[k]), k
    assert m0["grads"].keys() == m1["grads"].keys()
    for k, g in m0["grads"].items():
        assert torch.equal(g, m1["grads"][k]), k
    assert s0.keys() == s1.keys()
    for k, v in s0.items():
        assert torch.equal(v, s1[k]), k
    assert torch.equal(g0, g1)


def test_remat_train_equals_plain_train(tmp_path):
    """``train()`` with remat, augmentation and dropout 0.5 (the
    defaults) for three steps: the same metrics, step for step, as
    without."""
    root = str(tmp_path / "synth")
    spec = synthetic.make_spec("training", directory=root, num_shards=2,
                               samples_per_shard=8)
    rows = {}
    for remat in (False, True):
        cfg = NetConfig(num_stack=1, num_fea=8, input_hw=(32, 32),
                        remat=remat)
        tcfg = TrainConfig(batch_size=2, sub_batch=2, summary_every=1,
                           histogram_every=0,
                           base_dir=str(tmp_path / f"remat{remat}"))
        train(spec, cfg, tcfg, max_steps=3, device="cpu", debug_level=0,
              log_fn=lambda *_: None)
        path = os.path.join(tcfg.base_dir, os.listdir(tcfg.base_dir)[0],
                            "metrics.jsonl")
        with open(path) as f:
            rows[remat] = [{k: v for k, v in json.loads(line).items()
                            if k not in ("sec_per_batch", "time")}
                           for line in f]
    assert len(rows[True]) == 3
    assert rows[True] == rows[False]


@pytest.fixture(scope="module")
def jax_remat_step(batch):
    """One JAX train step with ``remat=True``, dropout 0, augmentation off,
    from the port's training init, with its averaged gradient."""
    variables = init_train_variables(NetConfig(**SHAPE, dropout_rate=0.0),
                                     seed=4)
    jnet = JNetConfig(**SHAPE, dropout_rate=0.0, remat=True)
    tcfg = JTrainConfig(**TCFG, augment=False)
    tx = jmake_optimizer(tcfg, STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=tx.init(params),
                        renorm_t=jnp.zeros((), jnp.float32), tx=tx,
                        apply_fn=JNet(jnet).apply)
    step = make_train_step(jnet, tcfg, donate=False, with_grads=True)
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, batch),
                              jax.random.key(0))
    return variables, jax.device_get((new_state, metrics))


def test_remat_step_matches_jax_remat_step(batch, jax_remat_step):
    variables, (new_j, m_j) = jax_remat_step
    cfg = NetConfig(**SHAPE, dropout_rate=0.0, remat=True)
    tcfg = TrainConfig(**TCFG, augment=False)
    state = create_train_state(cfg, tcfg, STEPS_PER_EPOCH,
                               variables=variables, device="cpu")
    m = train_step(state, _torch_batch(batch), cfg, tcfg, with_grads=True)
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
    assert float(state.renorm_t) == float(new_j.renorm_t)
