"""The training path on the card, at a small size: one step against the
same step on the CPU, and ``train()`` with validation on the fused decode
kernel (K1), a resume and a served checkpoint; the training tooling of
``chip_smoke.py``'s ``tooling`` phase (remat against the plain step, the
fused step against the pipeline's crop and the step, the event file, the
profiler's trace and the debug images, the host crop and the uint16 wire).

These tests need an NVIDIA GPU with the CUDA toolkit (K1 is built by nvcc
on first use) and skip elsewhere. They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py -q

Tolerances, as ``chip_smoke.py``'s full-width step: loss rtol 2e-4, each
parameter's averaged gradient within relative norm 5e-2, moving
statistics rtol 2e-3 / atol 2e-5 (float32, TF32 off).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import chip_smoke  # noqa: E402
from chip_smoke import phase_train_card_vs_cpu, pose_boxes  # noqa: E402
from densereg_torch import NetConfig, Predictor  # noqa: E402
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.config import TrainConfig, model_desc  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.ops import fused_decode as ops  # noqa: E402
from densereg_torch.train import train  # noqa: E402

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
