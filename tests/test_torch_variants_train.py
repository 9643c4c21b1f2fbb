"""Training of the network variants ``um_v1_lite`` and ``um_v1_deconv`` in
the port against the JAX package: one accumulated train step from the same
training-init weights and batch (s1/f8/J3 at 64 input, hourglass depth 3,
batch 2 x sub_batch 2, augmentation off, dropout 0); then ``train()`` on
synthetic shards with validation, and ``test()`` on its checkpoint.

Tolerances (``tests/test_torch_train.py``'s): the loss rtol 2e-4; every
parameter's averaged gradient within 5e-2 in relative norm (the float32
reduction-order floor through the renorm backward); the moving statistics
rtol 2e-3 / atol 2e-5. The JAX step is compiled once per variant.
"""

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

from densereg_torch import Predictor  # noqa: E402
from densereg_torch.config import NetConfig, TrainConfig, model_desc  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.models import init_train_variables, to_flax  # noqa: E402
from densereg_torch.models.bridge import flax_tree  # noqa: E402
from densereg_torch.train import create_train_state, train, train_step  # noqa: E402
from densereg_torch.train import loop as tloop  # noqa: E402
from test_torch_train import _flat, _torch_batch, make_batch  # noqa: E402

SHAPE = dict(num_stack=1, num_fea=8, num_joint=3, input_hw=(64, 64))
TCFG = dict(batch_size=2, sub_batch=2, augment=False)
STEPS_PER_EPOCH = 100.0
VARIANTS = ("um_v1_lite", "um_v1_deconv")


def _net(module):
    return NetConfig(**SHAPE, net_module=module, dropout_rate=0.0)


@pytest.fixture(scope="module")
def batch():
    return make_batch(np.random.default_rng(8), TCFG["sub_batch"],
                      TCFG["batch_size"], j=3, hw=64)


@pytest.fixture(scope="module")
def steps(batch):
    """One JAX train step per variant (with the averaged gradient), from
    the port's numpy training init."""
    out = {}
    for module in VARIANTS:
        jnet = JNetConfig(**SHAPE, net_module=module, dropout_rate=0.0)
        variables = init_train_variables(_net(module), seed=4)
        tcfg = JTrainConfig(**TCFG)
        tx = jmake_optimizer(tcfg, STEPS_PER_EPOCH)
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree.map(
                                jnp.asarray, variables["batch_stats"]),
                            opt_state=tx.init(params),
                            renorm_t=jnp.zeros((), jnp.float32), tx=tx,
                            apply_fn=JNet(jnet).apply)
        step = make_train_step(jnet, tcfg, donate=False, with_grads=True)
        new_state, metrics = step(state, jax.tree.map(jnp.asarray, batch),
                                  jax.random.key(0))
        out[module] = variables, jax.device_get((new_state, metrics))
    return out


@pytest.mark.parametrize("module", VARIANTS)
def test_train_step_matches_jax(steps, batch, module):
    """The loss, every parameter's averaged gradient (the depthwise
    kernels', and the transposed convolutions' at every hourglass level,
    whose kernels take weight decay as in JAX), the moving statistics and
    the schedule clock."""
    variables, (new_j, m_j) = steps[module]
    cfg = _net(module)
    state = create_train_state(cfg, TrainConfig(**TCFG), STEPS_PER_EPOCH,
                               variables=variables, device="cpu")
    m = train_step(state, _torch_batch(batch), cfg, TrainConfig(**TCFG),
                   with_grads=True)
    np.testing.assert_allclose(float(m["loss"]), float(m_j["loss"]),
                               rtol=2e-4)
    grads = _flat(flax_tree(m["grads"]))
    want = _flat(m_j["grads"])
    assert grads.keys() == want.keys()
    special = [p for p in want if "deconv_up" in p or (
        module == "um_v1_lite" and p.endswith("conv2/conv/kernel"))]
    assert len(special) >= 6, sorted(want)[:10]
    for path, g in want.items():
        rel = np.linalg.norm(grads[path] - g) / (np.linalg.norm(g) + 1e-12)
        assert rel < 5e-2, (path, rel)
    stats = _flat(to_flax(state.net)["batch_stats"])
    for path, val in _flat(new_j.batch_stats).items():
        np.testing.assert_allclose(stats[path], val, rtol=2e-3, atol=2e-5,
                                   err_msg=path)
    assert float(state.renorm_t) == float(new_j.renorm_t)
    assert state.step == int(new_j.step) == 1


@pytest.mark.parametrize("module", VARIANTS)
def test_train_and_test_run_the_variant(module, tmp_path):
    """``train()`` in its training form with validation, named by
    ``model_desc(..., net_name)`` as the JAX package names its runs, then
    the test driver and ``Predictor.from_checkpoint`` on its checkpoints."""
    cfg = NetConfig(num_stack=1, num_fea=8, input_hw=(32, 32),
                    net_module=module)
    spec = synthetic.make_spec("training", directory=str(tmp_path / "s"),
                               num_shards=1, samples_per_shard=8)
    val = synthetic.make_spec("validation", directory=str(tmp_path / "s"),
                              num_shards=1, samples_per_shard=4, seed=1)
    tcfg = TrainConfig(batch_size=2, sub_batch=2, base_dir=str(tmp_path),
                       validate_every=2, keep_best=True,
                       best_score_frames=4)
    quiet = lambda *_: None  # noqa: E731
    state = train(spec, cfg, tcfg, val_spec=val, max_steps=2,
                  net_name=module, device="cpu", log_fn=quiet)
    assert state.step == 2 and state.net.cfg.net_module == module
    run = os.path.join(str(tmp_path), model_desc(spec.name, spec.subset, cfg,
                                                 tcfg.augment, module))
    assert os.path.isdir(os.path.join(run, "ckpt_best"))
    with open(os.path.join(run, "training_log.txt")) as f:
        assert "[validation]" in f.read()
    test_spec = synthetic.make_spec("testing", directory=str(tmp_path / "s"),
                                    num_shards=1, samples_per_shard=5)
    report = tloop.test(test_spec, cfg, tcfg, net_name=module,
                        train_spec=spec, device="cpu", log_fn=quiet)
    assert report["num_frames"] == 5
    assert np.isfinite(np.asarray(report["max_errors"])).all()
    pred = Predictor.from_checkpoint(run, cfg, spec.cfg, max_batch=2,
                                     use_best=True, device="cpu")
    assert pred.net_cfg.net_module == module
    frames = np.load(test_spec.filenames[0])["depth"][:2]
    assert np.isfinite(pred(frames, np.asarray(
        [[20, 40, 220, 280, 600.0]] * 2, np.float32))).all()
