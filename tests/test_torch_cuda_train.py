"""The training path on the card, at a small size: one step against the
same step on the CPU, and ``train()`` with validation on the fused decode
kernel (K1), a resume and a served checkpoint.

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

from chip_smoke import phase_train_card_vs_cpu, pose_boxes  # noqa: E402
from densereg_torch import NetConfig, Predictor  # noqa: E402
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
                  log_fn=lambda *_: None)
    assert state.step == 3 and next(state.net.parameters()).is_cuda
    # each validation: a 3-frame batch, then the 8 scoring frames
    assert ops.fused_decode.launches == 6
    assert ops.fused_decode.launches_by_path["strided"] == 0
    resumed = train(spec, NET, tcfg, val_spec=val, max_steps=4, device=cuda,
                    restore_step="auto", log_fn=lambda *_: None)
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
