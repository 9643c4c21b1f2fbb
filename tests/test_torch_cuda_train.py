"""The training path on the card, at a small size: one step against the
same step on the CPU, and ``train()`` with validation on the fused decode
kernel (K1), a resume and a served checkpoint; the training tooling of
``chip_smoke.py``'s ``tooling`` phase (remat against the plain step, the
fused step against the pipeline's crop and the step, the event file, the
profiler's trace and the debug images, the host crop and the uint16 wire);
then the training step's CUDA graph (``train.step.MicroBatchGraph``)
against the eager step, a capture again after a gradient set to None, and
a resume after graphed steps against an uninterrupted graphed run.

These tests need an NVIDIA GPU with the CUDA toolkit (K1 is built by nvcc
on first use) and skip elsewhere. They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py -q

Tolerances, as ``chip_smoke.py``'s full-width step: loss rtol 2e-4, each
parameter's averaged gradient within relative norm 5e-2, moving
statistics rtol 2e-3 / atol 2e-5 (float32, TF32 off). The graph against
the eager step is held to the benchmark's limits for its train cell
(:data:`GRAPH_LIMITS`).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import chip_smoke  # noqa: E402
from chip_smoke import phase_train_card_vs_cpu, pose_boxes  # noqa: E402
from densereg_torch import NetConfig, Predictor  # noqa: E402
from densereg_torch.models import init_train_variables, init_variables  # noqa: E402
from densereg_torch.config import TrainConfig, model_desc  # noqa: E402
from densereg_torch.data import InputPipeline, synthetic  # noqa: E402
from densereg_torch.ops import fused_decode as ops  # noqa: E402
from densereg_torch.train import create_train_state, train, train_step  # noqa: E402
from densereg_torch.train import step as step_lib  # noqa: E402
from densereg_torch.train.checkpoint import CheckpointManager  # noqa: E402

NET = NetConfig(num_stack=2, num_fea=16, num_joint=16, input_hw=(32, 32))


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode kernel has no CPU form")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.fixture
def specs(tmp_path):
    root = str(tmp_path / "synth")
    return (synthetic.make_spec("training", directory=root, num_shards=2,
                                samples_per_shard=16),
            synthetic.make_spec("validation", directory=root, num_shards=1,
                                samples_per_shard=8, seed=1))


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda, specs):
    row = phase_train_card_vs_cpu(specs[0], NET, cuda)   # raises if off
    assert row["loss_rel_diff"] <= 2e-4
    assert row["max_grad_rel_norm"] <= 5e-2
    assert row["stats_max_excess_over_tol"] <= 0.0


@pytest.mark.cuda
def test_train_on_card_validates_with_the_kernel(cuda, specs, tmp_path):
    spec, val = specs
    tcfg = TrainConfig(batch_size=4, sub_batch=2, validate_every=1,
                       keep_best=True, base_dir=str(tmp_path / "runs"))
    ops.fused_decode.launches = 0
    ops.fused_decode.launches_by_path = dict.fromkeys(ops.PATHS, 0)
    state = train(spec, NET, tcfg, val_spec=val, max_steps=3, device=cuda,
                  debug_level=0, log_fn=lambda *_: None)
    assert state.step == 3 and next(state.net.parameters()).is_cuda
    # each validation: a 3-frame batch, then the 8 scoring frames
    assert ops.fused_decode.launches == 6
    assert ops.fused_decode.launches_by_path["strided"] == 0
    resumed = train(spec, NET, tcfg, val_spec=val, max_steps=4, device=cuda,
                    restore_step="auto", debug_level=0,
                    log_fn=lambda *_: None)
    assert resumed.step == 4
    run = os.path.join(tcfg.base_dir, model_desc(spec.name, spec.subset, NET,
                                                 tcfg.augment))
    reader = val.readers()[0]
    bbxs = pose_boxes(torch.from_numpy(reader["pose"][:4]), val.cfg,
                      val.fixed_bg_threshold)
    ops.fused_decode.launches = 0
    got = Predictor.from_checkpoint(run, NET, val.cfg, max_batch=4,
                                    device=cuda)(reader["depth"][:4], bbxs)
    assert got.shape == (4, 48) and np.isfinite(got).all()
    assert ops.fused_decode.launches == 1


@pytest.mark.cuda
def test_remat_on_card_matches_the_plain_step(cuda, specs):
    """One 40 x 5 step with and without remat, dropout on, from one state
    and generator seed: the loss, gradients and moving statistics within
    the card-vs-CPU limits, the generator's state equal (each check of
    ``chip_smoke.tooling_remat`` raises if off)."""
    row = chip_smoke.tooling_remat(specs[0], NET, cuda)
    assert row["generator_state_equal"]
    assert row["loss_rel_diff"] <= 2e-4 and row["max_grad_rel_norm"] <= 5e-2


@pytest.mark.cuda
def test_fused_step_on_card_matches_pipeline_and_step(cuda, specs):
    row = chip_smoke.tooling_fused(specs[0], NET, cuda)
    assert row["first_step_max_grad_rel_norm"] <= 5e-2
    assert row["max_loss_rel_diff"] <= 2e-4
    assert row["fused"]["samples_per_s"] > 0


@pytest.mark.cuda
def test_train_events_trace_and_debug_images_on_card(cuda, specs, tmp_path):
    """The event file's scalars and Flax-tagged histograms, a Chrome trace
    holding kernel events, the debug images (checked inside)."""
    row = chip_smoke.tooling_observability(*specs, NET, str(tmp_path), cuda)
    assert row["trace_kernel_events"] > 0
    assert len(row["debug_image_tags"]) == 7


@pytest.mark.cuda
def test_host_preprocess_and_wire_on_card(cuda, specs, tmp_path):
    row = chip_smoke.tooling_wire(specs[0], NET, init_variables(NET, seed=4),
                                  str(tmp_path), cuda)
    assert row["crop_uint16_vs_float32_host_mm"] <= row["wire_bound_mm"]
    assert row["test_float32_vs_device_crop"]["joints_off_unexplained"] == 0


# the benchmark's train-cell limits and its readings: each step's loss gap
# over the eager loss; the first averaged gradient's and the change's
# (parameters and moving statistics, over the steps) worst leaf, a leaf's
# gap the gap of the two norms over the eager norm or the median leaf's,
# whichever is larger, over the leaves whose eager gradient reaches a
# thousandth of the median leaf's (and every moving statistic)
GRAPH_LIMITS = {"loss": 3.5e-4, "grad1": 1e-3, "change": 0.055}
GRAPH_TCFG = TrainConfig(batch_size=8, sub_batch=3)


def _worst_leaf(got: dict, want: dict, keys) -> float:
    norms = {k: float(want[k].double().norm()) for k in keys}
    floor = float(np.median(list(norms.values())))
    return max(abs(float(got[k].double().norm()) - norms[k])
               / max(norms[k], floor, 1e-30) for k in keys)


def _batches(spec, cfg, n, device):
    pipe = InputPipeline(spec, GRAPH_TCFG.batch_size, GRAPH_TCFG.sub_batch,
                         cfg.input_hw, seed=5, device=device)
    try:
        it = iter(pipe)
        return [next(it) for _ in range(n)]
    finally:
        pipe.close()


def _run_steps(cfg, batches, device, monkeypatch, graphed,
               deterministic=False, drop_grad_after=None):
    """Steps from one init and generator seed, graphed or (with
    ``graphed`` patched off) eager, with cuDNN's deterministic algorithms
    or its default ones; with ``drop_grad_after``, the first parameter's
    gradient is set to None after that step, and the old gradient tensor
    is kept to see whether anything writes it later."""
    with monkeypatch.context() as m:
        m.setattr(torch.backends.cudnn, "deterministic", deterministic)
        if not graphed:
            m.setattr(step_lib, "graphed", lambda *a, **kw: False)
        state = create_train_state(cfg, GRAPH_TCFG, 100.0,
                                   variables=init_train_variables(cfg, 3),
                                   device=device)
        before = {k: v.detach().clone()
                  for k, v in state.net.state_dict().items()}
        gen = torch.Generator(device=device)
        gen.manual_seed(11)
        counts = dict(step_lib.graph_counts)
        out = {"loss": [], "stale": None}
        for i, batch in enumerate(batches):
            metrics = train_step(state, batch, cfg, GRAPH_TCFG, gen,
                                 with_grads=i == 0)
            out["loss"].append(float(metrics["loss"]))
            if i == 0:
                out["grad1"] = metrics["grads"]
            if i == drop_grad_after:
                p = next(state.net.parameters())
                out["stale"] = (p.grad, p.grad.clone())
                p.grad = None
        torch.cuda.synchronize()
        out["change"] = {k: v.detach() - before[k]
                         for k, v in state.net.state_dict().items()}
        out["generator"] = gen.get_state()
        out["counts"] = {k: v - counts[k]
                         for k, v in step_lib.graph_counts.items()}
    return out


def _gaps(graph, eager) -> dict:
    grads = {k: float(g.double().norm()) for k, g in eager["grad1"].items()}
    median = float(np.median(list(grads.values())))
    moved = [k for k, v in grads.items() if v >= 1e-3 * median]
    stats = [k for k in eager["change"] if k.endswith((".mean", ".var"))]
    return {"loss": max(abs(a - b) / abs(b) for a, b in
                        zip(graph["loss"], eager["loss"])),
            "grad1": _worst_leaf(graph["grad1"], eager["grad1"], moved),
            "change": _worst_leaf(graph["change"], eager["change"],
                                  moved + stats)}


def _bit_equal(graph, eager) -> bool:
    return (graph["loss"] == eager["loss"]
            and all(torch.equal(graph[part][k], eager[part][k])
                    for part in ("grad1", "change") for k in eager[part]))


@pytest.mark.cuda
@pytest.mark.parametrize("module", ["um_v1", "um_v1_lite", "um_v1_deconv"])
def test_graphed_steps_match_the_eager_steps(cuda, specs, monkeypatch,
                                             module):
    """4 steps of 8 x 3, augmentation and dropout on, from one init and
    seed: with cuDNN's default algorithms the graphed steps lie within the
    benchmark's limits of the eager ones (cuDNN's unordered sums part two
    eager runs as far); with its deterministic ones they equal them bit
    for bit. The generator ends where the eager one does; one warm-up
    pass, one capture, every later micro-batch a replay."""
    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=16, input_hw=(32, 32),
                    net_module=module)
    batches = _batches(specs[0], cfg, 4, cuda)
    graph = _run_steps(cfg, batches, cuda, monkeypatch, graphed=True)
    eager = _run_steps(cfg, batches, cuda, monkeypatch, graphed=False)
    gaps = _gaps(graph, eager)
    print(json.dumps({"module": module, "gaps": gaps,
                      "counts": graph["counts"]}))
    assert all(gaps[k] <= GRAPH_LIMITS[k] for k in gaps), gaps
    assert torch.equal(graph["generator"], eager["generator"])
    micro = 4 * GRAPH_TCFG.sub_batch
    assert graph["counts"] == {"captures": 1, "replays": micro - 2,
                               "eager": 1}
    assert eager["counts"] == {"captures": 0, "replays": 0, "eager": micro}
    assert _bit_equal(*(_run_steps(cfg, batches, cuda, monkeypatch, graphed=g,
                                   deterministic=True)
                        for g in (True, False)))


@pytest.mark.cuda
def test_graph_captures_again_after_a_gradient_is_set_to_none(
        cuda, specs, monkeypatch):
    """A gradient set to None between steps is made anew, so the graph
    captures again: the old gradient is never written, and the steps
    equal the eager ones bit for bit (cuDNN's deterministic
    algorithms)."""
    batches = _batches(specs[0], NET, 3, cuda)
    graph, eager = (_run_steps(NET, batches, cuda, monkeypatch, graphed=g,
                               deterministic=True, drop_grad_after=0)
                    for g in (True, False))
    stale, kept = graph["stale"]
    assert torch.equal(stale, kept)
    assert _bit_equal(graph, eager)
    assert graph["counts"] == {"captures": 2, "replays": 3 * 3 - 3,
                               "eager": 1}


@pytest.mark.cuda
def test_graphed_resume_continues_bit_for_bit(cuda, specs, tmp_path,
                                              monkeypatch):
    """train() for 4 graphed steps, against 2 steps, a checkpoint after
    the second (a replayed step) and a resumed call for the last 2: the
    same weights, moving statistics, Adam moments, clock and generator, to
    the bit. cuDNN picks deterministic algorithms here, so that two runs
    of the same kernels sum alike."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    spec = specs[0]
    cfg = lambda d: TrainConfig(batch_size=4, sub_batch=3,
                                base_dir=str(tmp_path / d))
    quiet = dict(device=cuda, debug_level=0, log_fn=lambda *_: None)
    counts = dict(step_lib.graph_counts)
    whole = train(spec, NET, cfg("a"), max_steps=4, **quiet)
    assert step_lib.graph_counts["replays"] - counts["replays"] == 4 * 3 - 2
    train(spec, NET, cfg("b"), max_steps=2, **quiet)
    resumed = train(spec, NET, cfg("b"), max_steps=4, restore_step="auto",
                    **quiet)
    for (k, x), y in zip(whole.net.state_dict().items(),
                         resumed.net.state_dict().values()):
        assert torch.equal(x, y), k
    sa, sb = whole.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    assert whole.step == resumed.step == 4
    assert torch.equal(whole.renorm_t, resumed.renorm_t)
    gens = [CheckpointManager(os.path.join(
        c.base_dir, model_desc(spec.name, spec.subset, NET, c.augment),
        "ckpt")).load(4)["generators"]["train"] for c in (cfg("a"), cfg("b"))]
    assert torch.equal(*gens)
