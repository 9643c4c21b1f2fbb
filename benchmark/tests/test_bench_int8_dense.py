"""The calibrated int8 ``um_v1`` cell at a small size on the CPU: it runs
through the runner's own entry and comes out correct against the plain
int8 reference, traced too, with set-up's host calls of the architecture's
kernel mix; a planted fault comes out not correct (one layer's calibrated
maximum doubled; the float net's answers in place of the int8 ones); the
controls fail a committed limit where the program passes; the yardstick
agrees with ``FlopCounterMode`` and with a hand count; and the new readers
give the values worked out by hand on a small trace."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import control_int8_dense
import counting_int8_dense
import devtrace
import run
from reference import net

CELL = "icvl16-int8-batch1024"
SMALL = dict(num_stack=2, num_fea=16, input_size=32, output_size=8)
SMALL_TRAFFIC = dict(pool_frames=12, request_frames=8, request_sets=3,
                     max_batch=4, calibration_frames=8,
                     trace_skip_requests=1, trace_requests=2)


def small_run(trace=False):
    return run.run_cell(CELL, 3000000019, 1, trace, device="cpu",
                        config_overrides=SMALL,
                        traffic_overrides=SMALL_TRAFFIC)


def limits():
    _, _, cfg, tr = common.load_cell(CELL)
    return cfg["limits"][tr["kind"]]


def fails(readings):
    lim = limits()
    return [k for k, v in readings.items() if v > lim[k]]


def test_sound_run_is_correct(capsys):
    """Set-up's warm request of two chunks runs two eager forwards on the
    CPU, each with 80 dense and 30 implicit K3 calls at s2/f16 on 32x32
    crops (29 bottleneck 3x3s and the stem), no depthwise one, and 53
    standalone quantize steps."""
    out = small_run()
    assert out["correct"] is True
    assert set(out["checks"]) == {"joints_off_1mm_pct", "worst_frame_gap_mm",
                                  "amax_gap_rel"}
    assert set(out["metrics"]) == {"setup_s", "frames_per_s"}
    line = [ln for ln in capsys.readouterr().err.splitlines()
            if ln.startswith("int8 host calls of set-up's warm request: ")]
    counts = json.loads(line[-1].split(": ", 1)[1])
    assert counts == dict(k3_dense=160, k3_implicit=60, dw=0, quantize=106,
                          quantize_kernel=0, dynamic=0, graph_captures=0,
                          graph_replays=0, host_forwards=2)


def test_traced_run_reads_no_device_metric_on_the_cpu():
    """On the CPU the trace holds no kernels: only the share of the peak,
    which counts frames, is read."""
    out = small_run(trace=True)
    assert out["correct"] is True
    assert set(out["metrics"]) == {"mfu.batch_int8_dense"}
    assert out["metrics"]["mfu.batch_int8_dense"]["value"] > 0


def doubled_amax(monkeypatch):
    import densereg_torch.serving as serving

    inner = serving.calibrate

    def doubled(net, batches):
        out = inner(net, batches)
        mod = getattr(net, "um_resA_s1").conv1
        mod.amax = mod.amax * 2.0
        return out

    monkeypatch.setattr(serving, "calibrate", doubled)


def float_answers(monkeypatch):
    """The predictor keeps the folded float weights and skips its
    calibration: it serves the float net."""
    import densereg_torch.serving as serving

    monkeypatch.setattr(serving, "quantize_weights", lambda v: v)
    monkeypatch.setattr(serving, "calibrate", lambda net, batches: net)


def test_doubled_amax_is_caught(monkeypatch):
    doubled_amax(monkeypatch)
    out = small_run()
    assert out["correct"] is False
    assert out["checks"]["amax_gap_rel"]["value"] == pytest.approx(1.0)


def test_float_answers_are_caught_by_the_joints(monkeypatch):
    float_answers(monkeypatch)
    out = small_run()
    assert out["correct"] is False
    assert {"joints_off_1mm_pct", "worst_frame_gap_mm"} & set(fails(
        {k: c["value"] for k, c in out["checks"].items()}))


def test_controls_fail_where_the_program_passes():
    prog = control_int8_dense.readings(CELL, 5, "program", "cpu", SMALL,
                                       SMALL_TRAFFIC)
    assert not fails(prog["program"])
    ctl = control_int8_dense.readings(CELL, 6, "control", "cpu", SMALL,
                                      SMALL_TRAFFIC)
    assert set(ctl) == {"control_bf16_float", "control_7bit"}
    for side, r in ctl.items():
        assert {"joints_off_1mm_pct", "worst_frame_gap_mm"} & set(fails(r)), \
            side


@pytest.mark.parametrize("small", [False, True])
def test_forward_ops_match_flop_counter(small):
    cfg = dict(common.load_cell(CELL)[2], **(SMALL if small else {}))
    params, _ = net.param_shapes(cfg)
    meta = {k: torch.empty(s, device="meta") for k, s in params.items()
            if "/bn/" not in k}
    for k, s in params.items():
        if k.endswith("/conv/kernel"):
            meta[k.replace("/kernel", "/bias")] = torch.empty(s[0],
                                                              device="meta")
    x = torch.empty((1, cfg["input_size"], cfg["input_size"], 1),
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        net.forward(net.Ctx(meta, "eval"), cfg, x)
    assert counting_int8_dense.forward_ops(cfg) == counter.get_total_flops()
    if not small:
        assert round(counting_int8_dense.forward_ops(cfg) / 1e9, 3) == 9.790
        kinds = [c["kind"] for c in counting_int8_dense.calls(cfg)]
        assert (kinds.count("k3_dense"), kinds.count("k3_implicit")) == \
            (104, 42)


def test_call_bytes_by_hand():
    """At batch 256: the stem (7x7/2, 1 -> 32, 128x128 in, 64x64 out, int8
    out), ``um_resA_s0/conv2`` (3x3, 80 -> 80 at 32x32, int8 out) and
    ``um_head_s1`` (1x1, 512 -> 48, float32 out)."""
    cfg = common.load_cell(CELL)[2]
    calls = {c["path"]: c for c in counting_int8_dense.calls(cfg, 256)}
    stem = calls["stem_conv"]
    assert stem["kind"] == "k3_implicit"
    assert stem["bytes"] == (256 * 128 * 128 + 32 * 49 + 8 * 32
                             + 256 * 64 * 64 * 32)
    assert stem["ops"] == 2 * 256 * 64 * 64 * 32 * 49
    px = 256 * 32 * 32
    mid = calls["um_resA_s0/conv2"]
    assert mid["kind"] == "k3_implicit"
    assert mid["bytes"] == px * 80 + 80 * 80 * 9 + 8 * 80 + px * 80
    assert mid["ops"] == 2 * px * 80 * 80 * 9
    head = calls["um_head_s1"]
    assert head["kind"] == "k3_dense"
    assert head["bytes"] == px * 512 + 512 * 48 + 8 * 48 + px * 48 * 4
    assert counting_int8_dense.bound_s(cfg, 256, ("k3_implicit",)) == \
        pytest.approx(sum(counting_int8_dense.least_s(c)
                          for c in calls.values()
                          if c["kind"] == "k3_implicit"), rel=1e-12)


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


K3 = "void (anonymous namespace)::k3_kernel<128>(Args)"
Q = "void (anonymous namespace)::quantize_flat<float, true>(Args)"
# A window of [0, 3000) µs with three replays, one a dispatch, each a
# cudaGraphLaunch whose correlation id its kernels carry. Each K3 record
# lasts 2 µs on the implicit GEMM and 1 µs on the dense entry, and a Q
# kernel sits between K3 records; the records are written out of order.
# The third replay lost its 10th K3 record.
KINDS = [c["kind"] for c in counting_int8_dense.calls(
    common.load_cell(CELL)[2])]


def replay(t0, corr, lose=None):
    out = [ev("cuda_runtime", "cudaGraphLaunch", t0, 5, corr)]
    t = t0 + 10
    for i, kind in enumerate(KINDS):
        dur = 2 if kind == "k3_implicit" else 1
        if i != lose:
            out.append(ev("kernel", K3, t, dur, corr))
        out.append(ev("kernel", Q, t + dur, 1, corr))
        t += dur + 1
    return out[::-1]


TRACE = ([ev("user_annotation", "bench.window", 0, 3000)]
         + replay(0, 11) + replay(1000, 12) + replay(2000, 13, lose=9))


def test_readers_on_known_kernels(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": TRACE}))
    cfg = common.load_cell(CELL)[2]
    trace = devtrace.Trace(str(path))
    r = common.Run(cfg, {}, trace, counts={"dispatches": 3, "frames": 768,
                                           "decode_batch": 256})
    n_impl, n_dense = KINDS.count("k3_implicit"), KINDS.count("k3_dense")
    assert KINDS[9] == "k3_implicit"      # the lost record: 2 µs
    all_us = 3 * (2 * n_impl + n_dense) - 2
    want = (100.0 * counting_int8_dense.bound_s(cfg, 256)
            / (all_us / 1e6 / 3))
    assert common.reader("k3_roofline.batch_int8_dense")(r) == \
        pytest.approx(want, rel=1e-12)
    assert len(counting_int8_dense.replays(r)) == 2
    want = (100.0 * counting_int8_dense.bound_s(cfg, 256, ("k3_implicit",))
            / (2 * n_impl / 1e6))
    assert common.reader("k3_implicit_roofline.batch_int8_dense")(r) == \
        pytest.approx(want, rel=1e-12)
    assert common.reader("mfu.batch_int8_dense")(r) == pytest.approx(
        100.0 * counting_int8_dense.forward_ops(cfg) * 768
        / (3e-3 * 1979e12), rel=1e-12)
    bare = common.Run(cfg, {}, trace)
    for name in ("k3_roofline.batch_int8_dense",
                 "k3_implicit_roofline.batch_int8_dense",
                 "mfu.batch_int8_dense"):
        assert common.reader(name)(bare) is None


def test_implicit_reader_needs_a_complete_replay(tmp_path):
    """Only the replay that lost a record: nothing to pair, so None; and
    kernels launched one by one, as an eager forward's are, carry no graph
    launch's correlation id."""
    cfg = common.load_cell(CELL)[2]
    counts = {"dispatches": 1, "frames": 256, "decode_batch": 256}
    eager = [ev("user_annotation", "bench.window", 0, 1000)]
    for i, kind in enumerate(KINDS):
        eager += [ev("cuda_runtime", "cudaLaunchKernel", 2 * i, 1, 100 + i),
                  ev("kernel", K3, 2 * i + 1, 1, 100 + i)]
    for events in ([ev("user_annotation", "bench.window", 0, 3000)]
                   + replay(2000, 13, lose=9), eager):
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"traceEvents": events}))
        r = common.Run(cfg, {}, devtrace.Trace(str(path)), counts=counts)
        assert common.reader("k3_implicit_roofline.batch_int8_dense")(r) \
            is None
        assert common.reader("k3_roofline.batch_int8_dense")(r) > 0
