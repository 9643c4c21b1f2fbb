"""The port's spans (``densereg_torch.utils.profiling.span``) on the CPU.

Under ``torch.profiler`` a ``Predictor`` request and a ``train()`` step
leave their named ranges in the Chrome trace, nested by time on the
launching thread as the span table of ``utils/profiling.py`` says; a
loaded export artifact's request leaves the live predictor's host spans. With no
profiler a span never enters ``record_function``; an exported program
holds no profiler op; and a profiler changes no answer and no training
step, bit for bit."""

import io
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch.config import TrainConfig  # noqa: E402
from densereg_torch.data import InputPipeline, synthetic  # noqa: E402
from densereg_torch.export import (  # noqa: E402
    export_predictor,
    load_exported,
    read_artifact,
)
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.train import (  # noqa: E402
    create_train_state,
    train,
    train_step,
)
from densereg_torch.utils import profiling  # noqa: E402

SHAPE = dict(num_stack=1, num_fea=8, num_joint=14, input_hw=(32, 32))
ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
NET = NetConfig(num_stack=1, num_fea=8, num_joint=16, input_hw=(32, 32))


def frames_and_boxes(b: int, seed: int = 3):
    """``b`` depth frames of a hand-sized blob at 350-450 mm over a far
    background, with boxes around it."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:240, 0:320].astype(np.float32)
    frames = np.full((b, 240, 320), 900.0, np.float32)
    bbxs = np.zeros((b, 5), np.float32)
    for i in range(b):
        cy, cx = rng.uniform(90, 150), rng.uniform(120, 200)
        inside = ((yy - cy) / 40.0) ** 2 + ((xx - cx) / 45.0) ** 2 < 1.0
        frames[i] = np.where(inside, 400.0 + 0.5 * (yy - cy), frames[i])
        bbxs[i] = (cy - 50, cx - 50, cy + 50, cx + 50, 550.0)
    return frames, bbxs


def spans(path) -> list:
    """The ``densereg.*`` ranges of a Chrome trace as ``(start, end,
    name)``, by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("densereg."))


def inside(outer, all_spans, name=None) -> list:
    """The spans within ``outer``'s interval (``outer`` itself left out),
    optionally only those named ``name``."""
    a, b, _ = outer
    return [s for s in all_spans if s != outer and a <= s[0] and s[1] <= b
            and (name is None or s[2] == name)]


def named(all_spans, name) -> list:
    return [s for s in all_spans if s[2] == name]


@pytest.fixture(scope="module")
def predictor():
    return Predictor(init_variables(NetConfig(**SHAPE), seed=11),
                     NetConfig(**SHAPE), ICVL, max_batch=4, device="cpu")


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    return synthetic.make_spec("training", directory=root, num_shards=2,
                               samples_per_shard=8)


def traced(fn, path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    return out


def test_a_request_of_two_chunks_leaves_its_spans(predictor, tmp_path):
    frames, bbxs = frames_and_boxes(6)
    traced(lambda: predictor(frames, bbxs), tmp_path / "t.json")
    got = spans(tmp_path / "t.json")
    (request,) = named(got, "densereg.predict")
    dispatches = named(got, "densereg.dispatch")
    fetches = named(got, "densereg.fetch")
    assert len(dispatches) == 2 and len(fetches) == 2
    assert set(inside(request, got)) == set(got) - {request}
    for d in dispatches:
        order = [s[2] for s in inside(d, got)]
        assert order == ["densereg.feed", "densereg.feed",
                         "densereg.preprocess", "densereg.net",
                         "densereg.decode"]
    # chunk k's fetch comes after chunk k+1's dispatch (double buffering)
    assert dispatches[1][1] <= fetches[0][0]


HOST_SPANS = ("densereg.predict", "densereg.dispatch", "densereg.feed",
              "densereg.fetch")


def host_nesting(all_spans) -> list:
    """Each host-side span, by start, as its name and the names of the host
    spans that hold it."""
    host = sorted((s for s in all_spans if s[2] in HOST_SPANS),
                  key=lambda s: (s[0], -s[1]))
    return [(s[2], tuple(o[2] for o in host
                         if o != s and o[0] <= s[0] and s[1] <= o[1]))
            for s in host]


def test_an_exported_request_leaves_the_live_host_spans(predictor,
                                                        tmp_path):
    """The same request of two chunks through the live predictor and
    through its loaded artifact opens the same predict, dispatch, feed and
    fetch spans, nested alike; the loaded programs hold no span of their
    own."""
    path = str(tmp_path / "p.pt2")
    export_predictor(predictor, path, u16=False)
    loaded = load_exported(path)
    frames, bbxs = frames_and_boxes(6)
    traced(lambda: predictor(frames, bbxs), tmp_path / "live.json")
    traced(lambda: loaded(frames, bbxs), tmp_path / "exported.json")
    live = spans(tmp_path / "live.json")
    exported = spans(tmp_path / "exported.json")
    assert host_nesting(exported) == host_nesting(live)
    assert {s[2] for s in exported} == set(HOST_SPANS)
    assert len(named(exported, "densereg.dispatch")) == 2
    # chunk k's fetch comes after chunk k+1's dispatch (double buffering)
    dispatches = named(exported, "densereg.dispatch")
    assert dispatches[1][1] <= named(exported, "densereg.fetch")[0][0]


def test_two_traced_train_steps_hold_their_phases(specs, tmp_path):
    cfg = TrainConfig(batch_size=2, sub_batch=2, base_dir=str(tmp_path),
                      profile_dir=str(tmp_path / "trace"), profile_start=0,
                      profile_steps=2)
    train(specs, NET, cfg, max_steps=2, debug_level=0, device="cpu",
          log_fn=lambda *_: None)
    got = spans(tmp_path / "trace" / "train_steps_0-2.pt.trace.json")
    steps = named(got, "densereg.train.step")
    assert len(steps) == 2
    for step in steps:
        held = inside(step, got)
        for name, count in (("densereg.pipeline.wait", 1),
                            ("densereg.pipeline.feed", 1),
                            ("densereg.train.augment_targets", 2),
                            ("densereg.train.forward_backward", 2),
                            ("densereg.train.optimizer", 1)):
            assert len(named(held, name)) == count, name
        assert not named(held, "densereg.train.all_reduce")
        assert [s[2] for s in held if not s[2].startswith(
            "densereg.train.augment")] == [
            "densereg.pipeline.wait", "densereg.pipeline.feed",
            "densereg.train.forward_backward",
            "densereg.train.forward_backward", "densereg.train.optimizer"]
        for fb in named(held, "densereg.train.forward_backward"):
            assert len(inside(fb, held,
                              "densereg.train.augment_targets")) == 1
    # every span of the trace lies in a step: none widens the window
    assert all(any(s[0] <= x[0] and x[1] <= s[1] for s in steps)
               for x in got)


def test_no_profiler_no_record_function(predictor, specs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(profiling, "record_function", refuse)
    assert profiling.span("densereg.predict") is profiling.span("x")
    predictor(*frames_and_boxes(6))
    pipe = InputPipeline(specs, 2, 2, NET.input_hw, device="cpu")
    try:
        batch = next(iter(pipe))
    finally:
        pipe.close()
    state = create_train_state(NET, TrainConfig(batch_size=2, sub_batch=2),
                               8.0, device="cpu")
    train_step(state, batch, NET, TrainConfig(batch_size=2, sub_batch=2),
               torch.Generator().manual_seed(0))


def test_a_profiler_records_only_its_own_thread():
    seen = {}

    def other():
        seen["span"] = profiling.span("densereg.predict")

    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("x") is not profiling.span("y")
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["span"] is profiling.span("z")


def test_exported_program_holds_no_profiler_op(predictor, tmp_path):
    path = str(tmp_path / "p.pt2")
    traced(lambda: export_predictor(predictor, path, u16=False),
           tmp_path / "t.json")
    _, blobs = read_artifact(path)
    for _, _, _, data in blobs:
        ep = torch.export.load(io.BytesIO(data))
        targets = [str(n.target) for n in ep.graph.nodes]
        assert targets and not [t for t in targets if "profiler" in t]


def test_a_profiler_changes_no_answer(predictor, tmp_path):
    frames, bbxs = frames_and_boxes(6, seed=5)
    plain = predictor(frames, bbxs)
    assert np.array_equal(
        traced(lambda: predictor(frames, bbxs), tmp_path / "t.json"), plain)


def test_a_profiler_changes_no_training_step(specs, tmp_path):
    tcfg = TrainConfig(batch_size=2, sub_batch=2)
    pipe = InputPipeline(specs, 2, 2, NET.input_hw, device="cpu")
    try:
        batch = next(iter(pipe))
    finally:
        pipe.close()
    states = []
    for trace in (False, True):
        state = create_train_state(NET, tcfg, 8.0, device="cpu")
        step = lambda: [train_step(state, batch, NET, tcfg,
                                   torch.Generator().manual_seed(7))
                        for _ in range(2)]
        if trace:
            traced(step, tmp_path / "t.json")
        else:
            step()
        states.append(state)
    a, b = (s.net.state_dict() for s in states)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    for p, q in zip(states[0].optimizer.state.values(),
                    states[1].optimizer.state.values()):
        assert all(torch.equal(p[k], q[k]) for k in p)
