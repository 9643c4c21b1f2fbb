"""``densereg_torch.train.train`` on the CPU: s1/f8/J16 at 32 input on
synthetic shards, 3 steps with a validation split, augmentation and
dropout on. Its files, checkpoint restore, SIGTERM stop and resume (equal
to an uninterrupted run bit for bit), the NaN guard, the emergency
checkpoint, ``keep_best`` and serving a checkpoint."""

import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_torch import Predictor  # noqa: E402
from densereg_torch.config import NetConfig, TrainConfig, model_desc  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.models import to_flax  # noqa: E402
from densereg_torch.train import (  # noqa: E402
    CheckpointManager,
    create_train_state,
    train,
)
from densereg_torch.train import loop  # noqa: E402

NET = NetConfig(num_stack=1, num_fea=8, num_joint=16, input_hw=(32, 32))


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    return (synthetic.make_spec("training", directory=root, num_shards=2,
                                samples_per_shard=8),
            synthetic.make_spec("validation", directory=root, num_shards=1,
                                samples_per_shard=5))


def tcfg(base_dir, **kw):
    return TrainConfig(**{**dict(batch_size=2, sub_batch=2,
                                 base_dir=str(base_dir), validate_every=1,
                                 ema_decay=0.9), **kw})


def run_dir(cfg, spec):
    return os.path.join(cfg.base_dir, model_desc(spec.name, spec.subset, NET,
                                                 cfg.augment))


def _equal_states(a, b):
    for (k, x), y in zip(a.net.state_dict().items(),
                         b.net.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert a.step == b.step and torch.equal(a.renorm_t, b.renorm_t)
    assert all(torch.equal(a.ema[k], b.ema[k]) for k in a.ema)


def test_train_writes_logs_and_checkpoints(specs, tmp_path):
    spec, val = specs
    cfg = tcfg(tmp_path)
    state = train(spec, NET, cfg, val_spec=val, max_steps=3, device="cpu",
                  log_fn=lambda *_: None)
    d = run_dir(cfg, spec)
    log = open(os.path.join(d, "training_log.txt")).read()
    assert "step 0/3, loss = " in log and "[validation] step 2" in log
    assert "validation error: [" in log
    rows = [json.loads(l) for l in open(os.path.join(d, "metrics.jsonl"))]
    assert rows[0]["step"] == 0 and np.isfinite(rows[0]["loss"])
    assert {"hm_loss", "hm3_loss", "um_loss", "reg_loss", "grad_norm",
            "param_norm", "learning_rate"} <= rows[0].keys()
    ckpt = CheckpointManager(os.path.join(d, "ckpt"))
    assert ckpt.steps() == [1, 3] and state.step == 3
    assert not any(n.endswith(".tmp") for n in os.listdir(ckpt.directory))
    assert float(state.renorm_t) == pytest.approx(6e-5, rel=1e-5)

    # restoring the last checkpoint gives back the same state
    fresh = create_train_state(NET, cfg, 1.0, device="cpu")
    gens = {"train": torch.Generator()}
    ckpt.restore(fresh, generators=gens)
    _equal_states(fresh, state)
    assert fresh.optimizer.count == 3
    assert not torch.equal(gens["train"].get_state(),
                           torch.Generator().get_state())


def test_sigterm_stop_and_resume_equals_uninterrupted(specs, tmp_path,
                                                      monkeypatch):
    spec, val = specs
    whole = train(spec, NET, tcfg(tmp_path / "a"), val_spec=val, max_steps=3,
                  device="cpu", log_fn=lambda *_: None)

    real = loop.train_step

    def preempt_after_first(state, *a, **kw):
        out = real(state, *a, **kw)
        if state.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    cfg = tcfg(tmp_path / "b")
    monkeypatch.setattr(loop, "train_step", preempt_after_first)
    stopped = train(spec, NET, cfg, val_spec=val, max_steps=3, device="cpu",
                    log_fn=lambda *_: None)
    monkeypatch.setattr(loop, "train_step", real)
    assert stopped.step == 1
    assert "SIGTERM" in open(os.path.join(run_dir(cfg, spec),
                                          "training_log.txt")).read()
    resumed = train(spec, NET, cfg, val_spec=val, max_steps=3, device="cpu",
                    restore_step="auto", log_fn=lambda *_: None)
    _equal_states(resumed, whole)


def test_nan_loss_raises_and_saves_nothing_for_it(specs, tmp_path,
                                                  monkeypatch):
    spec, _ = specs
    real = loop.train_step

    def diverge_at_second(state, *a, **kw):
        out = real(state, *a, **kw)
        if state.step == 2:
            out["loss"] = out["loss"] * float("nan")
        return out

    monkeypatch.setattr(loop, "train_step", diverge_at_second)
    cfg = tcfg(tmp_path, checkpoint_every=1)
    with pytest.raises(FloatingPointError, match="at step 1"):
        train(spec, NET, cfg, max_steps=3, device="cpu",
              log_fn=lambda *_: None)
    ckpt = CheckpointManager(os.path.join(run_dir(cfg, spec), "ckpt"))
    assert ckpt.steps() == [1]


def test_exception_leaves_an_emergency_checkpoint(specs, tmp_path,
                                                  monkeypatch):
    spec, _ = specs
    real = loop.train_step

    def fail_at_third(state, *a, **kw):
        if state.step == 2:
            raise RuntimeError("device lost")
        return real(state, *a, **kw)

    monkeypatch.setattr(loop, "train_step", fail_at_third)
    cfg = tcfg(tmp_path)
    with pytest.raises(RuntimeError, match="device lost"):
        train(spec, NET, cfg, max_steps=3, device="cpu",
              log_fn=lambda *_: None)
    ckpt = CheckpointManager(os.path.join(run_dir(cfg, spec), "ckpt"))
    assert ckpt.steps() == [1, 2]


def test_keep_best_marks_only_committed_checkpoints(specs, tmp_path,
                                                    monkeypatch):
    spec, val = specs
    events = []
    real_save, real_dump = CheckpointManager.save, loop.json.dump

    def save(self, state, *a, **kw):
        out = real_save(self, state, *a, **kw)
        events.append(("save", os.path.basename(self.directory), state.step))
        return out

    def dump(obj, f, *a, **kw):
        events.append(("marker", obj["step"]))
        return real_dump(obj, f, *a, **kw)

    monkeypatch.setattr(CheckpointManager, "save", save)
    monkeypatch.setattr(loop.json, "dump", dump)
    cfg = tcfg(tmp_path, keep_best=True, best_score_frames=4)
    train(spec, NET, cfg, val_spec=val, max_steps=3, device="cpu",
          log_fn=lambda *_: None)
    markers = [i for i, e in enumerate(events) if e[0] == "marker"]
    assert markers
    for i in markers:
        assert events[i - 1] == ("save", "ckpt_best", events[i][1])
    d = run_dir(cfg, spec)
    best = json.load(open(os.path.join(d, "best.json")))
    assert best["frames"] == 4 and np.isfinite(best["err"])
    assert CheckpointManager(os.path.join(d, "ckpt_best")).steps() == [
        best["step"]]


def test_predictor_serves_a_checkpoint(specs, tmp_path):
    spec, val = specs
    cfg = tcfg(tmp_path, keep_best=True)
    state = train(spec, NET, cfg, val_spec=val, max_steps=2, device="cpu",
                  log_fn=lambda *_: None)
    d = run_dir(cfg, spec)
    reader = spec.readers()[0]
    frames = reader["depth"][:3]
    bbxs = np.tile(np.array([[40, 80, 200, 240, 600]], np.float32), (3, 1))
    want = Predictor(to_flax(state.net), NET, spec.cfg, max_batch=4,
                     device="cpu")(frames, bbxs)
    got = Predictor.from_checkpoint(d, NET, spec.cfg, max_batch=4,
                                    device="cpu")(frames, bbxs)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (3, 48) and np.isfinite(got).all()
    ema = Predictor.from_checkpoint(d, NET, spec.cfg, use_ema=True,
                                    max_batch=4, device="cpu")(frames, bbxs)
    assert not np.array_equal(ema, got)
    best = json.load(open(os.path.join(d, "best.json")))
    assert Predictor.from_checkpoint(d, NET, spec.cfg, step=best["step"],
                                     use_best=True, device="cpu",
                                     max_batch=4)(frames, bbxs).shape == (3, 48)
