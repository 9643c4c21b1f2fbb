"""Data parallelism of the port on the CPU: two processes joined in a gloo
group (``parallel.initialize_distributed``) against one process and against
the JAX package's single-device step, mirroring ``tests/test_multiprocess.py``
and ``tests/test_parallel.py``.

The workers run this file itself (``python tests/test_torch_parallel.py
--worker RANK WORLD ADDRESS OUTDIR``), import no JAX, and write what they
computed under OUTDIR; the tests compare it here.

Tolerances, those of ``tests/test_parallel.py``: the loss rtol 2e-4; each
parameter's averaged gradient (before the clip) within a relative norm of
5e-2, the float32 reduction-order floor through the renorm backward
(``tests/test_torch_train.py`` holds the port's step to the JAX step at the
same bound); the moving statistics rtol 2e-3, atol 2e-5. xyz 0.02 mm, the
serving tests' bound (``tests/test_torch_serving.py``): the convolutions of
a smaller batch may sum in another order.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch.config import EvalConfig, TrainConfig  # noqa: E402
from densereg_torch.convert import save_converted  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.data.pipeline import partition_for_host  # noqa: E402
from densereg_torch.models import init_train_variables  # noqa: E402
from densereg_torch.models import init_variables, to_flax  # noqa: E402
from densereg_torch.models.bridge import flax_tree  # noqa: E402
from densereg_torch.train.state import create_train_state  # noqa: E402
from densereg_torch.train.step import train_step  # noqa: E402

NPROC = 2
SHAPE = dict(num_stack=1, num_fea=8, num_joint=3, input_hw=(32, 32))
NET = NetConfig(**SHAPE, dropout_rate=0.0)
TCFG = dict(batch_size=8, sub_batch=2, augment=False)
STEPS_PER_EPOCH = 100.0
ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
ENET = NetConfig(num_stack=1, num_fea=8, num_joint=synthetic.JNT_NUM,
                 input_hw=(32, 32))
SERVE = dict(num_stack=1, num_fea=8, num_joint=14, input_hw=(32, 32))
XYZ_ATOL_MM = 0.02


def make_batch(rng, sub, b, j=3, hw=32):
    """``tests/test_torch_train.py``'s batch: raw-mm crops near 400 mm with
    a quarter of the pixels background, poses around them."""
    cam = (241.42, 241.42, 160.0, 120.0)
    s = hw / 320.0, hw / 240.0
    cfg = np.array([cam[0] * s[0], cam[1] * s[1], cam[2] * s[0],
                    cam[3] * s[1], hw, hw], np.float32)
    poses = np.zeros((sub, b, j, 3), np.float32)
    poses[..., 0] = rng.uniform(-30, 30, (sub, b, j))
    poses[..., 1] = rng.uniform(-30, 30, (sub, b, j))
    poses[..., 2] = rng.uniform(380, 420, (sub, b, j))
    dm = rng.uniform(350, 450, (sub, b, hw, hw, 1)).astype(np.float32)
    dm[rng.random(dm.shape) < 0.25] = 0.0
    return {"dm": dm, "pose": poses.reshape(sub, b, -1),
            "cfg": np.tile(cfg, (sub, b, 1)), "com": poses.mean(axis=2)}


def hand_frames(rng, b):
    """``tests/test_torch_serving.py``'s requests: a noisy ellipse near
    400 mm over a far background, boxes around it."""
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    frames = np.full((b, 240, 320), 900.0, np.float32)
    bbxs = np.zeros((b, 5), np.float32)
    for i in range(b):
        cy, cx = rng.uniform(90, 150), rng.uniform(120, 200)
        ry, rx = rng.uniform(30, 60), rng.uniform(30, 60)
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        surf = 400.0 + 0.5 * (yy - cy) + rng.normal(0, 3.0, yy.shape)
        frames[i] = np.where(inside, surf, frames[i])
        bbxs[i] = [cy - ry - 8, cx - rx - 5, cy + ry + 6, cx + rx + 9, 520.0]
    return np.round(frames), bbxs


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def one_step(batch, group=None, remat=False):
    """One port train step from the seeded weights on ``batch`` (this
    rank's slice under ``group``): metrics with the averaged gradient, and
    the state after it."""
    from densereg_torch.models import sync_batch_renorm

    net = NetConfig(**SHAPE, dropout_rate=0.0, remat=remat)
    state = create_train_state(net, TrainConfig(**TCFG), STEPS_PER_EPOCH,
                               variables=init_train_variables(NET, seed=4),
                               device="cpu")
    if group is not None:
        sync_batch_renorm(state.net, group)
    m = train_step(state, _torch(batch), net, TrainConfig(**TCFG),
                   with_grads=True, group=group)
    return m, state


def _step_record(m, state):
    rec = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    arrays = {"grads/" + k: v for k, v in _flat(flax_tree(m["grads"])).items()}
    flax = to_flax(state.net)
    arrays.update({"params/" + k: v for k, v in _flat(flax["params"]).items()})
    arrays.update({"stats/" + k: v
                   for k, v in _flat(flax["batch_stats"]).items()})
    return rec, arrays


# --------------------------------------------------------------------------
# the worker
# --------------------------------------------------------------------------

def worker(rank: int, world: int, address: str, outdir: str) -> None:
    import torch.distributed as dist

    from densereg_torch.parallel import (
        initialize_distributed,
        make_mesh,
        shard_batch,
    )
    from densereg_torch.train import train
    from densereg_torch.train.loop import test

    assert initialize_distributed(address, world, rank, backend="gloo")
    mesh = make_mesh(devices=["cpu"])
    assert (mesh.rank, mesh.world_size, mesh.size) == (rank, world, world)
    report = {}

    # one data-parallel step on this rank's half of the global batch
    gbatch = make_batch(np.random.default_rng(42), TCFG["sub_batch"],
                        TCFG["batch_size"])
    local = shard_batch(gbatch, mesh, batch_dim=1)
    report["local_batch"] = list(local["dm"].shape)
    m, state = one_step({k: v.numpy() for k, v in local.items()},
                        mesh.group)
    rec, arrays = _step_record(m, state)
    report["step"] = rec
    np.savez(os.path.join(outdir, f"step_{rank}.npz"), **arrays)
    # the same step rematerialised: the recompute all-reduces again
    m_r, state_r = one_step({k: v.numpy() for k, v in local.items()},
                            mesh.group, remat=True)
    rec_r, arrays_r = _step_record(m_r, state_r)
    report["remat_step"] = rec_r
    np.savez(os.path.join(outdir, f"remat_{rank}.npz"), **arrays_r)

    # train() under the mesh: two steps on each rank's shards
    data = os.path.join(outdir, "data")
    spec = synthetic.make_spec("training", directory=data, num_shards=4,
                               samples_per_shard=4)
    st = train(spec, ENET, TrainConfig(batch_size=4, sub_batch=1,
                                       base_dir=os.path.join(outdir, "mp"),
                                       log_every=1, summary_every=1),
               max_steps=2, debug_level=0, log_fn=lambda *_: None,
               mesh=mesh, device="cpu")
    np.savez(os.path.join(outdir, f"trained_{rank}.npz"),
             **_flat(to_flax(st.net)["params"]))

    # test(): shard-partitioned evaluation merged on rank 0
    tspec = synthetic.make_spec("testing", directory=data, num_shards=4,
                                samples_per_shard=4)
    rep = test(tspec, ENET, TrainConfig(base_dir=os.path.join(outdir, "mp")),
               EvalConfig(batch_size=4),
               init_params=os.path.join(outdir, "payload.msgpack"),
               log_fn=lambda *_: None, mesh=mesh, device="cpu")
    report["eval_frames"] = rep["num_frames"]

    # serving over the mesh: every rank makes the same calls
    frames, bbxs = hand_frames(np.random.default_rng(2), 6)
    pred = Predictor(init_variables(NetConfig(**SERVE), seed=11),
                     NetConfig(**SERVE), ICVL, max_batch=4,
                     batch_buckets=(1,), mesh=mesh, device="cuda")
    np.save(os.path.join(outdir, f"xyz_{rank}.npy"), pred(frames, bbxs))
    np.save(os.path.join(outdir, f"xyz1_{rank}.npy"),
            pred(frames[:1], bbxs[:1]))

    with open(os.path.join(outdir, f"report_{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_mp")
    data = str(out / "data")
    # the shards and the payload exist before the workers start
    synthetic.make_spec("training", directory=data, num_shards=4,
                        samples_per_shard=4)
    synthetic.make_spec("testing", directory=data, num_shards=4,
                        samples_per_shard=4)
    save_converted({**init_variables(ENET, seed=3), "renorm_t": 0.0},
                   str(out / "payload.msgpack"))
    address = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(NPROC), address, str(out)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(NPROC)]
    logs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    reports = []
    for r in range(NPROC):
        with open(out / f"report_{r}.json") as f:
            reports.append(json.load(f))
    return out, reports


@pytest.fixture(scope="module")
def single():
    """The same step in one process on the whole global batch."""
    gbatch = make_batch(np.random.default_rng(42), TCFG["sub_batch"],
                        TCFG["batch_size"])
    return gbatch, _step_record(*one_step(gbatch))


@pytest.fixture(scope="module")
def jax_step(single):
    """The JAX package's single-device step on the same weights and batch
    (the oracle, built once)."""
    import jax
    import jax.numpy as jnp

    from densereg_tpu.config import NetConfig as JNetConfig
    from densereg_tpu.config import TrainConfig as JTrainConfig
    from densereg_tpu.models import DenseRegNet as JNet
    from densereg_tpu.train.state import TrainState as JTrainState
    from densereg_tpu.train.state import make_optimizer
    from densereg_tpu.train.step import make_train_step

    gbatch, _ = single
    variables = init_train_variables(NET, seed=4)
    tcfg = JTrainConfig(**TCFG)
    tx = make_optimizer(tcfg, STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=jax.tree.map(jnp.asarray,
                                                 variables["batch_stats"]),
                        opt_state=tx.init(params),
                        renorm_t=jnp.zeros((), jnp.float32), tx=tx,
                        apply_fn=JNet(JNetConfig(**SHAPE,
                                                 dropout_rate=0.0)).apply)
    step = make_train_step(JNetConfig(**SHAPE, dropout_rate=0.0), tcfg,
                           donate=False, with_grads=True)
    new, m = step(state, jax.tree.map(jnp.asarray, gbatch),
                  jax.random.key(0))
    return jax.device_get((new, m))


def _assert_step_close(got_rec, got, want_rec, want):
    np.testing.assert_allclose(got_rec["loss"], want_rec["loss"], rtol=2e-4)
    grads = {k: v for k, v in want.items() if k.startswith("grads/")}
    assert grads and grads.keys() <= got.keys()
    for k, g in grads.items():
        rel = np.linalg.norm(got[k] - g) / (np.linalg.norm(g) + 1e-12)
        assert rel < 5e-2, (k, rel)
    stats = {k: v for k, v in want.items() if k.startswith("stats/")}
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(got[k], v, rtol=2e-3, atol=2e-5,
                                   err_msg=k)


def test_partition_for_host_disjoint_and_covering():
    shards = [f"shard-{i:02d}" for i in range(10)]
    parts = [partition_for_host(shards, h, 3) for h in range(3)]
    assert sum(len(p) for p in parts) == 10
    assert set().union(*map(set, parts)) == set(shards)
    assert not set(parts[0]) & set(parts[1])
    assert not set(parts[1]) & set(parts[2])
    # fewer shards than processes: each keeps them all
    assert partition_for_host(shards[:2], 1, 3) == shards[:2]
    assert partition_for_host(shards, 0, 1) == shards


def test_local_batches_are_the_ranks_halves(runs):
    _, reports = runs
    for r in reports:
        assert r["local_batch"] == [TCFG["sub_batch"],
                                    TCFG["batch_size"] // NPROC, 32, 32, 1]


def test_two_process_step_matches_one_process(runs, single):
    """Loss, averaged gradients and the synchronized moving statistics of
    the 2-process gloo step against the same step on the global batch in
    one process; both ranks end with the same parameters."""
    out, reports = runs
    _, (rec, arrays) = single
    for r in range(NPROC):
        got = dict(np.load(out / f"step_{r}.npz"))
        _assert_step_close(reports[r]["step"], got, rec, arrays)
    p0, p1 = np.load(out / "step_0.npz"), np.load(out / "step_1.npz")
    for k in p0.files:
        if not k.startswith("grads/"):
            np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)


def test_two_process_step_matches_jax(runs, jax_step):
    """The 2-process step against the JAX package's single-device step on
    the same weights and global batch."""
    out, reports = runs
    new_j, m_j = jax_step
    want = {"grads/" + k: v for k, v in _flat(m_j["grads"]).items()}
    want.update({"stats/" + k: v
                 for k, v in _flat(new_j.batch_stats).items()})
    got = dict(np.load(out / "step_0.npz"))
    _assert_step_close(reports[0]["step"], got, {"loss": float(m_j["loss"])},
                       want)


def test_remat_step_under_a_group_matches_plain(runs):
    """``remat`` with a group: the recompute all-reduces the moments again
    and replays the moving statistics, so the step is the plain one."""
    out, reports = runs
    for r in range(NPROC):
        plain = np.load(out / f"step_{r}.npz")
        remat = np.load(out / f"remat_{r}.npz")
        assert reports[r]["remat_step"] == reports[r]["step"]
        for k in plain.files:
            np.testing.assert_array_equal(remat[k], plain[k], err_msg=k)


def test_train_under_a_mesh_keeps_ranks_equal(runs):
    """train(mesh=...): both ranks hold the same parameters after two
    steps; rank 0 alone writes the checkpoints and metrics, rank 1 its own
    text log."""
    out, _ = runs
    a, b = np.load(out / "trained_0.npz"), np.load(out / "trained_1.npz")
    assert a.files == b.files
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    (run,) = [d for d in (out / "mp").iterdir() if d.name.startswith(
        "synthetic_training")]
    names = set(os.listdir(run))
    assert {"training_log.txt", "training_log.p1.txt",
            "metrics.jsonl", "ckpt"} <= names
    assert "ckpt_2.pt" in os.listdir(run / "ckpt")
    with open(run / "metrics.jsonl") as f:
        assert [json.loads(line)["step"] for line in f] == [0, 1]


def test_multihost_eval_merges_to_single_process(runs, tmp_path):
    """The merged dump of test(mesh=...) over two processes equals the
    single-process test() files line for line (contiguous shard ranges,
    batch-aligned here, so the batches are the same too)."""
    from densereg_torch.train.loop import test

    out, reports = runs
    tspec = synthetic.make_spec("testing", directory=str(out / "data"),
                                num_shards=4, samples_per_shard=4)
    assert reports[0]["eval_frames"] == tspec.exact_num   # rank 0: merged
    assert reports[1]["eval_frames"] == tspec.exact_num // NPROC
    test(tspec, ENET, TrainConfig(base_dir=str(tmp_path)),
         EvalConfig(batch_size=4), init_params=str(out / "payload.msgpack"),
         log_fn=lambda *_: None, device="cpu")
    (run,) = [d for d in (out / "mp").iterdir()
              if (d / "testing-step0-result.txt").exists()]
    (single_dir,) = list(tmp_path.iterdir())
    for suffix in ("result.txt", "result_error.txt"):
        (want,) = [p for p in single_dir.iterdir()
                   if p.name.endswith("-" + suffix)]
        merged = (run / f"testing-step0-{suffix}").read_text().splitlines()
        assert merged == want.read_text().splitlines(), suffix
    assert len(merged) == 17


def test_predictor_over_a_mesh_matches_predictor(runs):
    """Predictor(mesh=...) over two ranks (each runs half of each
    dispatch, then the gather) against the Predictor, both ranks alike."""
    out, _ = runs
    frames, bbxs = hand_frames(np.random.default_rng(2), 6)
    pred = Predictor(init_variables(NetConfig(**SERVE), seed=11),
                     NetConfig(**SERVE), ICVL, max_batch=4,
                     batch_buckets=(1,), device="cpu")
    for name, want in (("xyz", pred(frames, bbxs)),
                       ("xyz1", pred(frames[:1], bbxs[:1]))):
        got = [np.load(out / f"{name}_{r}.npy") for r in range(NPROC)]
        np.testing.assert_array_equal(got[0], got[1])
        assert got[0].shape == want.shape
        err = np.abs(got[0] - want).max()
        assert err <= XYZ_ATOL_MM, (name, err)


def test_make_mesh_takes_this_ranks_card(monkeypatch):
    """Under a process group a process holds one card, the one
    ``initialize_distributed`` made current; without one, a mesh holds
    every visible card. More than one card a process under a group is
    refused. (A machine of two cards, as this process is shown it.)"""
    from densereg_torch.parallel import make_mesh

    monkeypatch.delenv("DENSEREG_VISIBLE_DEVICES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    group = object()   # stands for a process group: nothing here calls it
    assert make_mesh().devices == cards
    assert make_mesh(group=group).devices == (cards[1],)
    with pytest.raises(ValueError, match="one device a process"):
        make_mesh(devices=cards, group=group)


def test_predictor_over_local_devices_matches_predictor():
    """A mesh of one process and two local devices: each dispatch split
    over two replicas of the module, against the Predictor."""
    from densereg_torch.parallel import make_mesh

    frames, bbxs = hand_frames(np.random.default_rng(2), 6)
    variables = init_variables(NetConfig(**SERVE), seed=11)
    kw = dict(max_batch=4, batch_buckets=(1,))
    pred = Predictor(variables, NetConfig(**SERVE), ICVL, device="cpu", **kw)
    meshed = Predictor(variables, NetConfig(**SERVE), ICVL,
                       mesh=make_mesh(devices=["cpu", "cpu"]), **kw)
    assert len(meshed._replicas) == 2
    for f, b in ((frames, bbxs), (frames[:1], bbxs[:1])):
        want, got = pred(f, b), meshed(f, b)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= XYZ_ATOL_MM


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, address, outdir = sys.argv[2:6]
        worker(int(rank), int(world), address, outdir)
    else:
        sys.exit("usage: python tests/test_torch_parallel.py --worker RANK "
                 "WORLD ADDRESS OUTDIR")
