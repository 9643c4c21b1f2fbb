"""The port's observability against the JAX package's: TensorBoard event
files (``utils.tb``), the visualization figures (``eval.visualization``),
``targets.um_xy_angle``, and what ``train()`` writes into its run (the
event file's tags in the JAX run's order, skeleton PNGs, debug images,
the profiler's Chrome trace).

The event files of the two writers are byte-equal once the clock is the
same (it is the only input they do not share: ``wall_time`` and the
file name's time); ``um_xy_angle`` within 1e-6 (a ``sin`` of float32).
"""

import glob
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax.numpy as jnp  # noqa: E402

from densereg_tpu import config as jconfig  # noqa: E402
from densereg_tpu import targets as jtargets  # noqa: E402
from densereg_tpu.data import synthetic as jsynthetic  # noqa: E402
from densereg_tpu.eval import visualization as jvis  # noqa: E402
from densereg_tpu.train import loop as jloop  # noqa: E402
from densereg_tpu.utils import tb as jtb  # noqa: E402

from densereg_torch import targets  # noqa: E402
from densereg_torch.config import NetConfig, TrainConfig  # noqa: E402
from densereg_torch.data import synthetic  # noqa: E402
from densereg_torch.eval import visualization as vis  # noqa: E402
from densereg_torch.train import train  # noqa: E402
from densereg_torch.utils import tb  # noqa: E402

quiet = lambda *_: None

RNG = np.random.default_rng(0)
HISTOGRAMS = {
    "spread": np.concatenate([np.linspace(-2, 2, 101), [0.0, 1e-30]]),
    "normal": RNG.normal(size=(3, 3, 8, 16)).astype(np.float32),
    "extremes": np.array([np.nan, np.inf, -np.inf, 1e-13, -3e19, 5.0]),
    "empty": np.zeros((0,)),
    "constant": np.full((7,), -0.25, np.float32),
}
IMAGES = {
    "rgb_uint8": (np.arange(24 * 32 * 3) % 256).astype(np.uint8).reshape(
        24, 32, 3),
    "gray_float": np.linspace(-0.2, 1.2, 64).reshape(8, 8),
    "gray_channel": RNG.uniform(size=(16, 12, 1)),
    "rgba": RNG.integers(0, 256, (5, 7, 4)).astype(np.uint8),
}


def _write(module, logdir, kind, name):
    w = module.EventWriter(str(logdir))
    if kind == "scalar":
        w.add_scalar("loss/total", 1.25, step=3)
        w.add_scalars({"lr": 1e-3, "loss/hm": np.float32(0.5)}, step=2 ** 40)
    elif kind == "histogram":
        w.add_histogram("params/" + name, HISTOGRAMS[name], step=5)
    else:
        w.add_image("val/" + name, IMAGES[name], step=6)
    w.close()
    return w.path


CASES = ([("scalar", "")] + [("histogram", k) for k in HISTOGRAMS]
         + [("image", k) for k in IMAGES])


@pytest.mark.parametrize("kind,name", CASES,
                         ids=[f"{k}-{n}" if n else k for k, n in CASES])
def test_records_byte_equal_to_jax(tmp_path, monkeypatch, kind, name):
    """The same calls on both writers, under one clock: the same file
    name and the same bytes; each package reads the other's file."""
    monkeypatch.setattr(tb.time, "time", lambda: 1_700_000_000.25)
    assert jtb.time is tb.time
    ours = _write(tb, tmp_path / "ours", kind, name)
    theirs = _write(jtb, tmp_path / "theirs", kind, name)
    assert os.path.basename(ours) == os.path.basename(theirs)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    a = list(tb.read_events(theirs))
    b = list(jtb.read_events(ours))
    assert len(a) == len(b) == (4 if kind == "scalar" else 2)
    for x, y in zip(a, b):
        assert json.dumps(x, default=repr, sort_keys=True) == json.dumps(
            y, default=repr, sort_keys=True)


def test_pure_python_crc32c(monkeypatch):
    """``google_crc32c`` is not on every machine: a copy of the module
    loaded without it computes crc32c by its own table (the check value
    of "123456789" is 0xE3069283) and frames records as the JAX
    package's writer does."""
    monkeypatch.setitem(sys.modules, "google_crc32c", None)
    spec = importlib.util.spec_from_file_location("tb_no_crc", tb.__file__)
    fallback = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fallback)
    assert fallback._crc32c(b"123456789") == 0xE3069283
    data = RNG.integers(0, 256, 1000).astype(np.uint8).tobytes()
    assert fallback._masked_crc(data) == jtb._masked_crc(data)


# --------------------------------------------------------------------------
# train(): the event file, the PNGs and the trace, against the JAX loop
# --------------------------------------------------------------------------

RUN = dict(batch_size=2, sub_batch=2, summary_every=2, histogram_every=2,
           validate_every=2, checkpoint_every=100)
STEPS = 3


def _events(train_dir):
    (path,) = glob.glob(os.path.join(train_dir, "summary",
                                     "events.out.tfevents.*"))
    return path


def _tags(path, reader):
    return [(e["step"], v["tag"]) for e in reader(path)
            for v in e.get("values", [])]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A port run and a JAX run of ``train()`` at one config, s1/f8 at 32
    input, 3 steps, every summary channel firing at steps 0 and 2,
    ``debug_level=2``; the port's run also profiles steps 1-2."""
    root = tmp_path_factory.mktemp("tb")
    synth = str(root / "synth")
    spec = synthetic.make_spec("training", directory=synth, num_shards=2,
                               samples_per_shard=8)
    val = synthetic.make_spec("validation", directory=synth, num_shards=1,
                              samples_per_shard=8, seed=1)
    shape = dict(num_stack=1, num_fea=8, num_joint=spec.jnt_num,
                 input_hw=(32, 32))
    tcfg = TrainConfig(**RUN, base_dir=str(root / "ours"),
                       profile_dir=str(root / "trace"), profile_start=1,
                       profile_steps=2)
    train(spec, NetConfig(**shape), tcfg, val_spec=val, max_steps=STEPS,
          debug_level=2, device="cpu", log_fn=quiet)
    jspec = jsynthetic.make_spec("training", directory=synth, num_shards=2,
                                 samples_per_shard=8)
    jval = jsynthetic.make_spec("validation", directory=synth, num_shards=1,
                                samples_per_shard=8, seed=1)
    jloop.train(jspec, jconfig.NetConfig(**shape),
                jconfig.TrainConfig(**RUN, base_dir=str(root / "jax")),
                val_spec=jval, max_steps=STEPS, debug_level=2, log_fn=quiet)
    run = os.listdir(tcfg.base_dir)[0]
    return (os.path.join(tcfg.base_dir, run), str(root / "jax" / run),
            tcfg.profile_dir)


def test_train_event_tags_match_jax_run(runs):
    """Scalars (sorted, then ``learning_rate``), the debug images, the
    ``params/`` and ``grads/`` histograms under the Flax key paths,
    ``val/max_joint_error`` and the skeleton images: the JAX run's tags,
    steps and order. Each package reads the port's file."""
    ours, theirs, _ = runs
    got = _tags(_events(ours), tb.read_events)
    want = _tags(_events(theirs), jtb.read_events)
    assert got == want
    assert got == _tags(_events(ours), jtb.read_events)
    tags = {t for _, t in got}
    assert {"loss", "learning_rate", "val/max_joint_error", "val_pts_0",
            "train/0/dm", "train/0/um_xy_est",
            "params/stem_conv/conv/kernel",
            "grads/um_head_s0/conv/bias"} <= tags
    assert sorted({s for s, _ in got}) == [0, 2]


def test_train_event_values(runs):
    """The records hold real values: finite scalars, histograms over every
    element of each parameter, PNG images of the head grid."""
    ours, _, _ = runs
    events = list(tb.read_events(_events(ours)))
    assert events[0]["file_version"] == "brain.Event:2"
    values = [v for e in events[1:] for v in e["values"]]
    scalars = [v["simple_value"] for v in values if "simple_value" in v]
    assert scalars and np.isfinite(scalars).all()
    kernel = next(v["histo"] for v in values
                  if v["tag"] == "params/stem_conv/conv/kernel")
    assert kernel["num"] == 7 * 7 * 1 * 32
    image = next(v["image"] for v in values if v["tag"] == "train/0/hm_gt")
    assert (image["height"], image["width"]) == (8, 8)
    assert image["png"][:8] == b"\x89PNG\r\n\x1a\n"


def test_train_writes_skeleton_pngs_and_a_trace(runs):
    ours, theirs, trace_dir = runs
    pngs = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(ours, "summary", "*.png")))
    assert pngs == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(theirs, "summary", "*.png")))
    assert pngs == [f"val_pts_{i}_{s}.png" for i in range(3) for s in (0, 2)]
    (trace,) = glob.glob(os.path.join(trace_dir, "*.json"))
    assert os.path.basename(trace) == "train_steps_1-3.pt.trace.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]


def test_debug_level_zero_draws_nothing(tmp_path):
    """``debug_level=0`` (no matplotlib needed): scalars, histograms and
    ``val/max_joint_error``, no image record and no PNG."""
    synth = str(tmp_path / "synth")
    spec = synthetic.make_spec("training", directory=synth, num_shards=1,
                               samples_per_shard=4)
    val = synthetic.make_spec("validation", directory=synth, num_shards=1,
                              samples_per_shard=4, seed=1)
    tcfg = TrainConfig(**dict(RUN, histogram_every=1),
                       base_dir=str(tmp_path / "run"))
    train(spec, NetConfig(num_stack=1, num_fea=8, input_hw=(32, 32)), tcfg,
          val_spec=val, max_steps=1, debug_level=0, device="cpu",
          log_fn=quiet)
    run = os.path.join(tcfg.base_dir, os.listdir(tcfg.base_dir)[0])
    values = [v for e in tb.read_events(_events(run))
              for v in e.get("values", [])]
    assert not glob.glob(os.path.join(run, "summary", "*.png"))
    assert not any("image" in v for v in values)
    assert any(v["tag"] == "val/max_joint_error" for v in values)
    assert any("histo" in v for v in values)


# --------------------------------------------------------------------------
# visualization and um_xy_angle
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(jvis.SKELETONS))
def test_skeleton_topologies_equal_jax(name):
    assert vis.SKELETONS[name]() == jvis.SKELETONS[name]()
    assert vis._dataset_key(name + "_x") == jvis._dataset_key(name + "_x")
    assert vis.FINGER_COLORS == jvis.FINGER_COLORS


def test_figures_and_summary_image_writer(tmp_path):
    rng = np.random.default_rng(1)
    hm = rng.uniform(0, 1, (32, 32))
    dm = rng.uniform(0, 1, (128, 128))
    uvd = rng.uniform(0, 128, (16, 3))
    figs = {"hm": vis.figure_heatmap(hm),
            "skel": vis.figure_joint_skeleton(dm, uvd, "icvl"),
            "cands": vis.figure_candidate_pairs(dm, uvd[:5, :2],
                                                uvd[5:10, :2])}
    theirs = {"hm": jvis.figure_heatmap(hm),
              "skel": jvis.figure_joint_skeleton(dm, uvd, "icvl"),
              "cands": jvis.figure_candidate_pairs(dm, uvd[:5, :2],
                                                   uvd[5:10, :2])}
    for k, fig in figs.items():
        np.testing.assert_array_equal(vis._fig_to_array(fig),
                                      jvis._fig_to_array(theirs[k]))
    events = tb.EventWriter(str(tmp_path / "ev"))
    w = vis.SummaryImageWriter(str(tmp_path), debug_level=2,
                               event_writer=events)
    assert w.save("hm", figs["hm"], 0, level=1)
    assert w.save("skel", figs["skel"], 0, level=2)
    assert w.save("hidden", figs["cands"], 0, level=3) is None
    paths = w.save_batch_skeletons("val", rng.uniform(0, 1, (5, 32, 32, 1)),
                                   rng.uniform(0, 32, (5, 21, 3)),
                                   "msra_P0", 7)
    assert len(paths) == 3 and all(os.path.exists(p) for p in paths)
    events.close()
    tags = [v["tag"] for e in tb.read_events(events.path)
            for v in e.get("values", [])]
    assert tags == ["hm", "skel", "val_0", "val_1", "val_2"]


def test_cv2_helpers_equal_jax():
    rng = np.random.default_rng(2)
    dm = rng.uniform(0, 900, (60, 80)).astype(np.float32)
    uvd = np.array([[10.0, 20.0, 400.0], [70.0, 50.0, 300.0]])
    np.testing.assert_array_equal(vis.colorize_depth(dm, 750.0),
                                  jvis.colorize_depth(dm, 750.0))
    np.testing.assert_array_equal(vis.annotate_depth(dm, uvd),
                                  jvis.annotate_depth(dm, uvd))


def test_um_xy_angle_matches_jax():
    rng = np.random.default_rng(3)
    ums = rng.normal(size=(2, 8, 8, 12)).astype(np.float32)
    ums[0, 0, 0, :3] = [0.0, 0.0, 1.0]          # pure z: the clamp
    ums[0, 0, 1, :3] = [0.1, 0.1, 0.1]          # short: 1
    got = targets.um_xy_angle(torch.from_numpy(ums)).numpy()
    want = np.asarray(jtargets.um_xy_angle(jnp.asarray(ums)))
    assert got.shape == (2, 8, 8, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
