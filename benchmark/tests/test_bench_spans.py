"""The readers of the program's spans on small hand-made Chrome traces:
one of two serving dispatches inside a window (with a third dispatch
after it, which no reader counts) and one of two training steps without
one, each with known spans, kernels joined to their launches by
correlation id, and idle gaps. Each reader gives the value worked out by
hand below, and None on a trace without ``densereg.*`` spans."""

import json

import pytest

import common
import devtrace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, a, b):
    return ev("user_annotation", "densereg." + name, a, b - a)


def launch(ts, corr, start, dur, tid=1):
    """A launch at ``ts`` and its kernel at ``[start, start + dur)``."""
    return [ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid=tid, corr=corr),
            ev("kernel", f"kernel_{corr}", start, dur, corr=corr)]


def dispatch(a, feeds, pre, net, dec):
    return ([span("dispatch", a, dec[1] + 20)]
            + [span("feed", *f) for f in feeds]
            + [span("preprocess", *pre), span("net", *net),
               span("decode", *dec)])


# Batch, in µs. Busy: [18, 22), [30, 34), [40, 72), [112, 118), [122, 128),
# [135, 168). Idle in the window [0, 200): [0, 18), [22, 30), [34, 40),
# [72, 112), [118, 122), [128, 135), [168, 200). Feeds [10, 25) and
# [100, 120) cover 8 + 3 + 12 + 2 = 25 of it.
BATCH = (
    [ev("user_annotation", "bench.window", 0, 200)]
    + dispatch(10, [(10, 20), (20, 25)], (25, 35), (35, 60), (60, 70))
    + dispatch(100, [(100, 115), (115, 120)], (120, 130), (130, 150),
               (150, 160))
    + dispatch(300, [(300, 310)], (310, 320), (320, 330), (330, 340))
    + [ev("gpu_memcpy", "Memcpy HtoD", 18, 4),
       ev("gpu_memcpy", "Memcpy HtoD", 112, 6)]
    + launch(26, 1, 30, 4) + launch(40, 2, 40, 30) + launch(62, 3, 70, 2)
    + launch(122, 4, 122, 6) + launch(135, 5, 135, 30)
    + launch(155, 6, 165, 3)
    + launch(312, 7, 312, 50) + launch(322, 8, 322, 50))


def step(a, wait, feed, passes, opt):
    return ([span("train.step", a, a + 100), span("pipeline.wait", *wait),
             span("pipeline.feed", *feed), span("train.optimizer", *opt)]
            + [s for fb, aug in passes
               for s in (span("train.forward_backward", *fb),
                         span("train.augment_targets", *aug))])


# Training, in µs, no window: the trace spans [0, 200). Busy: [22, 26),
# [35, 45), [52, 53), [60, 75), [85, 90), [142, 146), [151, 165),
# [171, 172), [175, 183), [188, 196). The forward and backward spans cover
# 30 + 18 = 48 µs of idle, 17 of it inside augment_targets.
TRAIN = (
    step(0, (0, 10), (10, 20), [((20, 50), (20, 30)), ((50, 80), (50, 55))],
         (80, 95))
    + step(100, (100, 130), (130, 140),
           [((140, 170), (140, 150)), ((170, 185), (170, 172))], (185, 198))
    + launch(21, 1, 22, 4) + launch(32, 2, 35, 10, tid=2)
    + launch(51, 3, 52, 1) + launch(60, 4, 60, 15) + launch(81, 5, 85, 5)
    + launch(141, 6, 142, 4) + launch(151, 7, 151, 14, tid=2)
    + launch(171, 8, 171, 1) + launch(173, 9, 175, 8)
    + launch(186, 10, 188, 8))

# metric: (trace, µs a dispatch or a step, by hand)
CASES = {
    "preprocess_ms.batch": (BATCH, (4 + 6) / 2),
    "net_span_ms.batch": (BATCH, (30 + 30) / 2),
    "decode_ms.batch": (BATCH, (2 + 3) / 2),
    "feed_idle_ms.batch": (BATCH, 25 / 2),
    "data_wait_ms.train": (TRAIN, (10 + 30) / 2),
    "augment_ms.train": (TRAIN, (4 + 1 + 4 + 1) / 2),
    "optimizer_ms.train": (TRAIN, (5 + 8) / 2),
    "fwd_bwd_idle_ms.train": (TRAIN, (48 - 17) / 2),
}


def run_of(events, tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return common.Run({}, {}, devtrace.Trace(str(path)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_on_known_spans(name, tmp_path):
    events, want_us = CASES[name]
    got = common.reader(name)(run_of(events, tmp_path))
    assert got == pytest.approx(want_us / 1e3, rel=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_without_spans(name, tmp_path):
    events = [e for e in CASES[name][0]
              if not e["name"].startswith("densereg.")]
    assert common.reader(name)(run_of(events, tmp_path)) is None
    assert common.reader(name)(common.Run({}, {})) is None
