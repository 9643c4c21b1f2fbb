"""The plain reference against the program, at small sizes on the CPU:
the parameter tree, the served joints in float32 and bfloat16, and the
first training steps, set-up's and the resumed call's (losses, the first
gradient, the weights and moving statistics after them)."""

import numpy as np
import pytest
import torch

import common
import frames
import weights
from drivers import batch, train
from reference import net
from reference import serving as ref_serving
from conftest import SMALL, SMALL_TRAFFIC


def cell(name):
    _, _, cfg, tr = common.load_cell(name)
    return dict(cfg, **SMALL), dict(tr, **SMALL_TRAFFIC[tr["kind"]])


@pytest.mark.parametrize("joints", [14, 16])
def test_parameter_tree_matches_program(joints):
    from densereg_torch.models.bridge import init_variables

    cfg = dict(cell("icvl16-f32-batch1024")[0], num_joint=joints)
    program = init_variables(common.net_config(cfg), seed=0)
    params, stats = net.param_shapes(cfg)

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", np.shape(v)

    hwio = lambda s: (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
    assert dict(flat(program["params"])) == {k: hwio(s)
                                             for k, s in params.items()}
    assert dict(flat(program["batch_stats"])) == stats


@pytest.mark.parametrize("name", ["icvl16-f32-batch1024",
                                  "nyu14-bf16-batch1024"])
def test_served_joints_match_program(name):
    cfg, tr = cell(name)
    pred, requests, pool, params, stats, cam = batch.build(cfg, tr, 7, "cpu")
    ref_pool = batch.reference_answers(cfg, params, stats, pool, cam,
                                       tr["max_batch"])
    for f, b, ix in requests:
        np.testing.assert_allclose(pred(f, b), ref_pool[ix], atol=1e-3)


def test_weights_are_calibrated():
    """The serving weights give heatmap heads in a trained net's range."""
    cfg, tr = cell("icvl16-f32-batch1024")
    gen = torch.Generator().manual_seed(3)
    depth, _, boxes = frames.render(16, cfg["camera"], cfg["num_joint"], gen,
                                    "cpu")
    cam = torch.tensor([cfg["camera"][k] for k in
                        ("fx", "fy", "cx", "cy", "w", "h")])
    crops = ref_serving.normed_crops(cfg, depth, boxes, cam)
    params, stats = weights.serving_weights(cfg, gen, crops[:8])
    heads = net.forward(net.Ctx(net.fold(params, stats), "eval"), cfg, crops)
    hm = heads["hm"][-1]
    assert 0.3 < float(hm.mean()) < 0.7 and 0.1 < float(hm.std()) < 0.5


def test_training_steps_match_program(tmp_path):
    cfg, tr = cell("icvl16-f32-train40x5")
    spec, shards, params0, stats0, payload = train.build(cfg, tr, 5, "cpu",
                                                         str(tmp_path))
    prog = train.program_steps(cfg, tr, 5, "cpu", str(tmp_path), spec,
                               payload)[0]
    ref = train.reference_steps(cfg, tr, 5, "cpu", shards, params0, stats0)
    assert len(prog["loss"]) == len(ref["loss"]) == (
        tr["checked_steps"] + tr["window_checked_steps"])
    np.testing.assert_allclose(prog["loss"], ref["loss"], rtol=1e-5)
    for k in params0:
        torch.testing.assert_close(prog["params"][k], ref["params"][k],
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(prog["clipped1"][k], ref["clipped1"][k],
                                   rtol=1e-4, atol=1e-6)
    for k in stats0:
        torch.testing.assert_close(prog["stats"][k], ref["stats"][k],
                                   rtol=1e-5, atol=1e-6)
    readings = train.readings(prog, ref, params0, stats0, tr["checked_steps"])
    assert max(readings.values()) < 1e-4


def test_batch_stream_is_the_programs(tmp_path):
    """The reference's shuffler draws the program's pipeline's batches."""
    from densereg_torch.config import CameraConfig
    from densereg_torch.data.base import DatasetSpec, ShardWriter
    from densereg_torch.data.pipeline import InputPipeline
    from reference import train as ref_train

    sizes = [5, 7, 3]
    paths = []
    for s, n in enumerate(sizes):
        p = str(tmp_path / f"s{s}.npz")
        with ShardWriter(p) as w:
            for i in range(n):
                w.add(np.full((8, 8), 300 + i, np.uint16),
                      np.full(3, 100 * s + i, np.float32), f"{s}/{i}")
        paths.append(p)
    spec = DatasetSpec("x", "training", CameraConfig(10, 10, 4, 4, 8, 8), 1,
                       500.0, str(tmp_path), paths, 15, 15)
    pipe = InputPipeline(spec, 2, 3, (8, 8), seed=11, device="cpu")
    try:
        it = iter(pipe)
        got = [next(it)["pose"].reshape(-1, 3)[:, 0].tolist()
               for _ in range(4)]
    finally:
        pipe.close()
    order = ref_train.batch_stream(sizes, 6, 11, 4)
    want = [[100.0 * r + i for r, ix in take for i in ix] for take in order]
    assert got == want
