"""A run with the timed path broken underneath comes out not correct:
the runner's own entry, past its look for a GPU, at a small size on the
CPU, with each fault the cell can have planted in the program, and the
limits as committed.

Serving cells: an answer altered where it is produced; half of a batch
left out, its rows answered with the other half's. The train cell: a step
that returns its state unchanged; half of each micro-batch left out, its
loss doubled; and, in the window's resumed call alone, the input pipeline
started from the first batch instead of the checkpoint's position, or
Adam's moments not restored."""

import copy

import pytest
import torch

import run
from conftest import CAMERAS, SMALL, SMALL_TRAFFIC, spec_with_cameras


def small_run(name, kind, seconds=1):
    return run.run_cell(name, 11, seconds, False, device="cpu",
                        spec=spec_with_cameras() if name == CAMERAS else None,
                        config_overrides=SMALL,
                        traffic_overrides=SMALL_TRAFFIC[kind])


def altered_answer(monkeypatch):
    import densereg_torch.serving as serving

    inner = serving.decode_poses

    def altered(*a, **kw):
        out = inner(*a, **kw)
        out["xyz"] = out["xyz"].clone()
        out["xyz"][0] += 40.0
        return out

    monkeypatch.setattr(serving, "decode_poses", altered)


def half_batch(monkeypatch):
    from densereg_torch.serving import Predictor

    inner = Predictor._predict

    def half(self, frames, bbxs):
        h = max(frames.shape[0] // 2, 1)
        out = inner(self, frames[:h], bbxs[:h])
        return torch.cat([out, out])[:frames.shape[0]]

    monkeypatch.setattr(Predictor, "_predict", half)


CELLS = [("nyu14-bf16-batch1024", "batch"), ("icvl16-f32-batch1024", "batch"),
         (CAMERAS, "cameras")]


@pytest.mark.parametrize("name,kind", CELLS)
def test_sound_run_is_correct(name, kind):
    assert small_run(name, kind)["correct"] is True


@pytest.mark.parametrize("fault", [altered_answer, half_batch])
@pytest.mark.parametrize("name,kind", CELLS)
def test_serving_fault_is_caught(monkeypatch, name, kind, fault):
    fault(monkeypatch)
    assert small_run(name, kind)["correct"] is False


def unchanged_state(monkeypatch):
    import densereg_torch.train.loop as loop

    inner = loop.train_step

    def unchanged(state, *a, **kw):
        params = copy.deepcopy(state.net.state_dict())
        opt = copy.deepcopy(state.optimizer.state_dict())
        metrics = inner(state, *a, **kw)
        state.net.load_state_dict(params)
        state.optimizer.load_state_dict(opt)
        return metrics

    monkeypatch.setattr(loop, "train_step", unchanged)


def half_micro_batch(monkeypatch):
    import densereg_torch.train.step as step

    inner = step.loss_fn

    def half(net, batch, *a, **kw):
        h = batch["dm"].shape[0] // 2
        loss, metrics = inner(net, {k: v[:h] for k, v in batch.items()},
                              *a, **kw)
        return 2.0 * loss, metrics

    monkeypatch.setattr(step, "loss_fn", half)


def restarted_feed(monkeypatch):
    """Touches only the resumed call: set-up's starts at step 0 anyway."""
    import densereg_torch.train.loop as loop

    inner = loop.InputPipeline

    def from_start(*a, **kw):
        return inner(*a, **dict(kw, skip=0))

    monkeypatch.setattr(loop, "InputPipeline", from_start)


def moments_not_restored(monkeypatch):
    """Touches only the resumed call, the one that restores."""
    from densereg_torch.train.checkpoint import CheckpointManager

    inner = CheckpointManager.restore

    def restore(self, state, *a, **kw):
        out = inner(self, state, *a, **kw)
        for moments in state.optimizer.state.values():
            for v in moments.values():
                if torch.is_tensor(v) and v.dim() > 0:
                    v.zero_()
        return out

    monkeypatch.setattr(CheckpointManager, "restore", restore)


def test_sound_training_run_is_correct():
    assert small_run("icvl16-f32-train40x5", "train")["correct"] is True


@pytest.mark.parametrize("fault", [unchanged_state, half_micro_batch,
                                   restarted_feed, moments_not_restored])
def test_training_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    assert small_run("icvl16-f32-train40x5", "train")["correct"] is False
