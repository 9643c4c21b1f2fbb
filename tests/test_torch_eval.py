"""The port's evaluation path against the JAX package's on the CPU: the
result and error-curve writers, ``evaluate_stream`` and the test driver
``train.loop.test``.

``test()`` parity: one payload written by the JAX package's
``save_converted`` from seeded variables (s1/f8/J16, 32x32 input), the same
synthetic testing shards (2 x 30 frames, ``exact_num`` 50, batch 8), the
JAX driver with its jnp decode against the port's on the CPU. Tolerance:
the decode's 2e-4 normalized bound (``PARITY.md``), 0.02 mm, plus 1e-4 mm
for the ``%.4f`` rounding of the result file. A frame whose error sits
within that bound of a curve threshold, or whose top-k candidates are near
a tie, is reported by the assertion, not absorbed by a wider bound.

Then the driver's weight sources against the port's own ``train()``
checkpoints: ``selected_step``, ``use_best``, ``use_ema`` and the two
``ValueError``s.
"""

import contextlib
import dataclasses
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from densereg_tpu import config as jconfig  # noqa: E402
from densereg_tpu import decode as jdecode  # noqa: E402
from densereg_tpu.convert import save_converted as jsave_converted  # noqa: E402
from densereg_tpu.data import synthetic as jsynthetic  # noqa: E402
from densereg_tpu.data.pipeline import TestPipeline as JTestPipeline  # noqa: E402
from densereg_tpu.eval import evaluate_stream as jevaluate_stream  # noqa: E402
from densereg_tpu.eval.writer import ResultWriter as JResultWriter  # noqa: E402
from densereg_tpu.eval.writer import write_error_curve as jwrite_curve  # noqa: E402
from densereg_tpu.models import DenseRegNet as JNet  # noqa: E402
from densereg_tpu.preprocess import method2_resize as jmethod2_resize  # noqa: E402
from densereg_tpu.preprocess import norm_dm as jnorm_dm  # noqa: E402
from densereg_tpu.train import loop as jloop  # noqa: E402
from densereg_tpu.train.state import TrainState as JTrainState  # noqa: E402

from densereg_torch import decode  # noqa: E402
from densereg_torch.config import EvalConfig, NetConfig, TrainConfig  # noqa: E402
from densereg_torch.config import model_desc  # noqa: E402
from densereg_torch.data import TestPipeline as TorchTestPipeline  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.eval import (  # noqa: E402
    ResultWriter,
    evaluate_stream,
    make_infer_fn,
    read_result_file,
    threshold_curve,
    write_error_curve,
)
from densereg_torch.models import DenseRegNet, from_flax, init_variables  # noqa: E402
from densereg_torch.preprocess import norm_dm  # noqa: E402
from densereg_torch.train import CheckpointManager, train  # noqa: E402
from densereg_torch.train import loop as tloop  # noqa: E402

SHAPE = dict(num_stack=1, num_fea=8, num_joint=16, input_hw=(32, 32))
NET = NetConfig(**SHAPE)
XYZ_TOL_MM = 0.02 + 1e-4
HEAD_TOL = 1e-4      # per head element (PARITY.md, network row)
quiet = lambda *_: None  # noqa: E731


def _scores_and_xyz(rng, n=23, j=16):
    names = [f"seq_{i % 3}/frame_{i:04d}.png" for i in range(n)]
    xyz = rng.normal(0, 80, (n, 3 * j)).astype(np.float32)
    xyz[0, :3] = [-0.00005, 1e6, 123.45655]      # rounding edge cases
    scores = np.concatenate([rng.uniform(0, 90, n - 3), [0.5, 80.5, 5.5]])
    return names, xyz, scores


def test_writers_write_the_jax_writers_bytes(tmp_path):
    names, xyz, scores = _scores_and_xyz(np.random.default_rng(4))
    for i, writer in enumerate((ResultWriter, JResultWriter)):
        with writer(str(tmp_path / f"r{i}.txt")) as w:
            w.write_batch(names[:10], xyz[:10])
            w.write(names[10], xyz[10])
            w.write_batch(names[11:], xyz[11:])
    for i, curve in enumerate((write_error_curve, jwrite_curve)):
        curve(scores.tolist(), str(tmp_path / "sub" / f"e{i}.txt"))
    assert (tmp_path / "r0.txt").read_bytes() == (tmp_path / "r1.txt").read_bytes()
    assert ((tmp_path / "sub" / "e0.txt").read_bytes()
            == (tmp_path / "sub" / "e1.txt").read_bytes())
    got_names, got = read_result_file(str(tmp_path / "r0.txt"))
    assert got_names == [n.replace("/", "\\") for n in names]
    np.testing.assert_allclose(got[1:], xyz[1:], atol=5e-5, rtol=1e-6)
    assert len((tmp_path / "sub" / "e0.txt").read_text().splitlines()) == 17


def _gt_batches(n_batches, b=3, pulled=None):
    for k in range(n_batches):
        if pulled is not None:
            pulled.append(k)
        yield {"dm": None, "cfg": None, "com": None,
               "pose": torch.ones((b, 6)) * k,
               "name": [f"n{k}_{i}" for i in range(b)]}


@pytest.mark.parametrize("exact_num", [7, 6, 9, 20])
def test_evaluate_stream_truncates_exactly(tmp_path, exact_num):
    """As ``tests/test_eval.py::test_evaluate_stream_end_to_end``: an infer
    that returns the ground truth gives zero error, and the stream stops at
    ``exact_num`` frames; no batch is taken from the stream or run once
    ``exact_num`` frames are issued, and none is dropped at a boundary. The
    JAX package's loop writes the same file."""
    calls, pulled = [], []

    def infer(variables, dm, cfg, com):
        calls.append(1)
        return variables["gt"][len(calls) - 1]

    gts = [torch.ones((3, 6)) * k for k in range(4)]
    report = evaluate_stream(infer, {"gt": gts}, _gt_batches(4, pulled=pulled),
                             exact_num=exact_num,
                             result_path=str(tmp_path / "r.txt"),
                             error_path=str(tmp_path / "e.txt"), log_fn=quiet)
    n = min(exact_num, 12)
    need = -(-n // 3)
    assert report["num_frames"] == n and len(report["max_errors"]) == n
    assert len(calls) == need and len(pulled) == need
    assert report["max_errors"] == [0.0] * n
    assert report["percentages"]["10mm"] == 1.0 and report["fps"] > 0
    names, xyz = read_result_file(str(tmp_path / "r.txt"))
    assert names == [f"n{k}_{i}" for k in range(4) for i in range(3)][:n]
    np.testing.assert_array_equal(xyz[:, 0], np.repeat(np.arange(4), 3)[:n])

    jcalls = []
    jreport = jevaluate_stream(
        lambda v, *a: (jcalls.append(1), v[len(jcalls) - 1].numpy())[1],
        gts, ({**b, "pose": b["pose"].numpy()} for b in _gt_batches(4)),
        exact_num=exact_num, result_path=str(tmp_path / "j.txt"),
        log_fn=quiet)
    assert jreport["num_frames"] == n
    assert (tmp_path / "r.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


@contextlib.contextmanager
def _flush_denormals():
    """Subnormals flushed to zero in torch's CPU arithmetic, as XLA's CPU
    backend computes (and the TPU)."""
    assert torch.set_flush_denormal(True)
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _jax_heads(variables, dm, cfg, com):
    """The JAX package's heads on a cropped batch, as its ``make_infer_fn``
    computes them, and the k-th best score of each joint's top-k list."""
    normed = jnorm_dm(dm, com)
    outs = JNet(jconfig.NetConfig(**SHAPE)).apply(variables, normed,
                                                  train=False)
    heads = (outs["hm"][-1], outs["hm3"][-1], outs["um"][-1],
             jmethod2_resize(normed, *NET.output_hw), cfg, com)
    scores = jdecode.refined_heatmaps(*heads[:2], heads[3])
    kth = jnp.sort(scores.reshape(len(dm), -1, NET.num_joint), axis=1)[
        :, -EvalConfig().num_candidates]
    return heads, kth


def _joint_causes(ours, theirs, variables, n):
    """For each of the first ``n`` frames and each joint, on the JAX
    package's own heads (its crop and net) and decode: whether its top-k
    list reaches a non-positive score (there ``lax.top_k`` orders +0 above
    -0, which the port does not: ROADMAP fault 3.2); whether its mean
    shift cancelled, i.e. a candidate weight is negative and the estimate
    left the box of the candidates that carry weight (a positive weighted
    mean stays inside it; a cancelled one divides by a sum near 0 and
    amplifies differences as small as the order of a sum); and the frame's
    largest head difference between the packages."""
    jax_heads = jax.jit(_jax_heads)
    net = from_flax(variables, NET)
    out = {k: [] for k in ("nonpositive_topk", "cancelled", "head_err")}
    for tb, jb in zip(TorchTestPipeline(ours, 8, NET.input_hw, device="cpu"),
                      JTestPipeline(theirs, 8, NET.input_hw)):
        jheads, kth = jax_heads(variables, jb["dm"], jb["cfg"], jb["com"])
        jres = jdecode.decode_poses(*jheads, jconfig.EvalConfig())
        cans, w = np.asarray(jres["candidates"]), np.asarray(jres["weights"])
        est = np.asarray(jres["normed"])
        live = (w != 0)[..., None]
        outside = ((est < np.where(live, cans, np.inf).min(2))
                   | (est > np.where(live, cans, -np.inf).max(2))).any(-1)
        with torch.inference_mode():
            heads = net(norm_dm(tb["dm"], tb["com"]))
        out["nonpositive_topk"].append(np.asarray(kth) <= 0)
        out["cancelled"].append((w < 0).any(-1) & outside)
        out["head_err"].append(np.max([
            np.abs(heads[k][-1].numpy() - np.asarray(j)).reshape(
                len(w), -1).max(-1)
            for k, j in zip(("hm", "hm3", "um"), jheads)], axis=0))
    return {k: np.concatenate(v)[:n] for k, v in out.items()}


def _jax_template_state(rng, net_cfg, tcfg, steps_per_epoch):
    """Stands in for the JAX package's ``create_train_state`` in its
    ``test()``, which with ``init_params`` uses the state only as the
    template of the parameter tree (and its default batch statistics)
    before putting the payload in it: the same tree, from the port's
    seeded init, without the eager ``net.init`` (about 45 s on one core)."""
    variables = init_variables(NET, seed=0)
    return JTrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"], opt_state=None,
                       renorm_t=jnp.zeros((), jnp.float32), ema_params=None,
                       tx=None, apply_fn=None)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """One JAX-written payload, one set of shards, both drivers' files, and
    the causes of any joint that differs (``_joint_causes``). The port runs
    with subnormals flushed, the arithmetic XLA's CPU backend runs the JAX
    driver in: otherwise a mean-shift Gaussian weight that underflows below
    2^-126 (a candidate some 530 mm from the estimate) still counts in the
    port and not in JAX (ROADMAP fault 3.3)."""
    root = tmp_path_factory.mktemp("eval")
    variables = init_variables(NET, seed=21)
    payload = str(root / "params.msgpack")
    jsave_converted({**variables, "renorm_t": 0.0}, payload)
    ours = dataclasses.replace(synthetic.make_spec(
        "testing", directory=str(root / "synth"), num_shards=2,
        samples_per_shard=30), exact_num=50)
    theirs = dataclasses.replace(jsynthetic.make_spec(
        "testing", directory=str(root / "synth"), num_shards=2,
        samples_per_shard=30), exact_num=50)
    assert ours.filenames == theirs.filenames
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloop, "create_train_state", _jax_template_state)
        jreport = jloop.test(
            theirs, jconfig.NetConfig(**SHAPE),
            jconfig.TrainConfig(base_dir=str(root / "jax")),
            jconfig.EvalConfig(batch_size=8), init_params=payload,
            log_fn=quiet)
    with _flush_denormals():
        report = tloop.test(ours, NET, TrainConfig(base_dir=str(root / "torch")),
                            EvalConfig(batch_size=8), init_params=payload,
                            log_fn=quiet, device="cpu")
    run = model_desc("synthetic", "training", NET, True)

    def files(side):
        found = {k: sorted(glob.glob(str(root / side / run / f"testing-*-{k}")))
                 for k in ("result.txt", "result_error.txt")}
        assert [len(v) for v in found.values()] == [1, 1], found
        return found["result.txt"][0], found["result_error.txt"][0]

    return dict(root=root, payload=payload, spec=ours, report=report,
                jreport=jreport, files=files("torch"), jfiles=files("jax"),
                causes=_joint_causes(ours, theirs, variables, 50))


def test_test_driver_matches_jax(parity):
    """Names equal, in shard order; every joint's xyz within the bound,
    except where the JAX decode is ill-posed on its own heads: non-positive
    scores in its top-k list (fault 3.2), or a cancelled mean shift (see
    ``_joint_causes``) on heads that agree with the port's within the
    network's 1e-4 (``PARITY.md``). Every such joint is listed by the
    assertion when another one fails. The error curves are equal once those
    frames' errors are taken from one package."""
    (res, err), (jres, jerr) = parity["files"], parity["jfiles"]
    assert os.path.basename(res).endswith("-result.txt")
    names, xyz = read_result_file(res)
    jnames, jxyz = read_result_file(jres)
    assert len(names) == 50 and names == jnames
    want = [str(n).replace("/", "\\") for f in parity["spec"].filenames
            for n in np.load(f)["name"]][:50]
    assert names == want
    c = parity["causes"]
    gap = np.abs(xyz - jxyz).reshape(50, -1, 3).max(-1)
    off = gap > XYZ_TOL_MM
    ill_posed = c["nonpositive_topk"] | (
        c["cancelled"] & (c["head_err"] <= HEAD_TOL)[:, None])
    explained = [(int(f), int(j), float(gap[f, j]))
                 for f, j in np.argwhere(off & ill_posed)]
    bad = [(int(f), int(j), float(gap[f, j]))
           for f, j in np.argwhere(off & ~ill_posed)]
    assert not bad, (f"(frame, joint, mm) off by more than {XYZ_TOL_MM} mm: "
                     f"{bad}; off where the JAX decode is ill-posed: "
                     f"{explained}")
    assert off.mean() < 0.05, explained

    jerrs = np.asarray(parity["jreport"]["max_errors"])
    errs = np.asarray(parity["report"]["max_errors"])
    flagged = off.any(-1)
    thresholds = np.asarray([0.5 + 5 * k for k in range(17)])
    near = np.flatnonzero(np.abs(jerrs[:, None] - thresholds).min(-1)
                          <= 2 * XYZ_TOL_MM)
    curve = [tuple(map(float, line.split())) for line in open(err)]
    jcurve = [tuple(map(float, line.split())) for line in open(jerr)]
    assert [t for t, _ in curve] == [t for t, _ in jcurve] == list(thresholds)
    mixed = np.where(flagged, jerrs, errs)
    assert threshold_curve(mixed)[1] == threshold_curve(jerrs)[1], (
        f"frames at a threshold: {near.tolist()}")
    assert ([p for _, p in curve] == [p for _, p in jcurve]
            or flagged.any()), near.tolist()
    assert parity["report"]["num_frames"] == parity["jreport"]["num_frames"] == 50
    np.testing.assert_allclose(errs[~flagged], jerrs[~flagged],
                               atol=2 * XYZ_TOL_MM, rtol=0)


def test_init_params_refuses_other_weight_sources(parity):
    for kw in (dict(use_ema=True), dict(use_best=True)):
        with pytest.raises(ValueError, match="init_params"):
            tloop.test(parity["spec"], NET,
                       TrainConfig(base_dir=str(parity["root"] / "torch")),
                       init_params=parity["payload"], device="cpu", **kw)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 3-step port run with an EMA, ``keep_best`` and a checkpoint every
    step; a 1-step run without an EMA; a small testing split."""
    root = tmp_path_factory.mktemp("runs")
    spec = synthetic.make_spec("training", directory=str(root / "synth"),
                               num_shards=1, samples_per_shard=8)
    val = synthetic.make_spec("validation", directory=str(root / "synth"),
                              num_shards=1, samples_per_shard=4, seed=1)
    test_spec = synthetic.make_spec("testing", directory=str(root / "synth"),
                                    num_shards=1, samples_per_shard=6)
    tcfg = TrainConfig(batch_size=2, sub_batch=1, base_dir=str(root / "ema"),
                       ema_decay=0.5, keep_best=True, validate_every=1,
                       checkpoint_every=1, best_score_frames=4)
    state = train(spec, NET, tcfg, val_spec=val, max_steps=3, device="cpu",
                  log_fn=quiet)
    plain = dataclasses.replace(tcfg, base_dir=str(root / "plain"),
                                ema_decay=None, keep_best=False)
    train(spec, NET, plain, max_steps=1, device="cpu", log_fn=quiet)
    run = os.path.join(tcfg.base_dir, model_desc(spec.name, spec.subset, NET,
                                                 tcfg.augment))
    return dict(spec=test_spec, tcfg=tcfg, plain=plain, state=state, run=run)


def _expected_lines(net, spec, tmp_path, name):
    """The result file of ``net`` (eval form) over ``spec``, written by
    ``evaluate_stream`` with the driver's batch size."""
    path = str(tmp_path / f"{name}.txt")
    evaluate_stream(make_infer_fn(NET, device="cpu"), net.eval(),
                    iter(TorchTestPipeline(spec, EvalConfig().batch_size,
                                      NET.input_hw, device="cpu")),
                    spec.exact_num, path, log_fn=quiet)
    return open(path).read()


def _driver_lines(trained, **kw):
    before = set(glob.glob(os.path.join(trained["run"], "testing-*-result.txt")))
    report = tloop.test(trained["spec"], NET, kw.pop("tcfg", trained["tcfg"]),
                        log_fn=quiet, device="cpu", **kw)
    new = set(glob.glob(os.path.join(trained["run"], "testing-*-result.txt")))
    (path,) = new - before
    assert report["num_frames"] == 6
    return open(path).read()


def _net(state_dict):
    net = DenseRegNet(NET)
    net.load_state_dict(state_dict)
    return net


def test_selected_step_use_best_and_use_ema(trained, tmp_path):
    state, run, spec = trained["state"], trained["run"], trained["spec"]
    ckpt = CheckpointManager(os.path.join(run, "ckpt"))
    assert ckpt.steps() == [1, 2, 3]
    # the latest checkpoint is the returned state's net
    latest = _driver_lines(trained)
    assert latest == _expected_lines(state.net, spec, tmp_path, "latest")
    assert _driver_lines(trained, selected_step=3) == latest
    # an earlier step: its checkpoint's net, not the latest
    first = _driver_lines(trained, selected_step=1)
    assert first == _expected_lines(_net(ckpt.load(1)["net"]), spec,
                                    tmp_path, "step1")
    assert first != latest
    # the EMA weights: the returned state's
    ema = _net({**state.net.state_dict(), **state.ema})
    assert _driver_lines(trained, use_ema=True) == _expected_lines(
        ema, spec, tmp_path, "ema")
    assert _expected_lines(ema, spec, tmp_path, "ema") != latest
    # the best-validation checkpoint, the step best.json names
    best = CheckpointManager(os.path.join(run, "ckpt_best"))
    with open(os.path.join(run, "best.json")) as f:
        assert best.steps() == [json.load(f)["step"]]
    assert _driver_lines(trained, use_best=True) == _expected_lines(
        _net(best.load()["net"]), spec, tmp_path, "best")


def test_use_ema_without_ema_weights_raises(trained):
    with pytest.raises(ValueError, match="EMA"):
        tloop.test(trained["spec"], NET, trained["plain"], use_ema=True,
                   log_fn=quiet, device="cpu")
    with pytest.raises(FileNotFoundError):
        tloop.test(trained["spec"], NET, trained["plain"], use_best=True,
                   log_fn=quiet, device="cpu")
