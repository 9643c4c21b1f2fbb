"""The calibrated int8 lite cell at a small size on the CPU: it runs through
the runner's own entry and comes out correct against the plain int8
reference, traced too; a planted fault comes out not correct (one layer's
calibrated maximum doubled; the float lite net's answers in place of the
int8 ones); the controls fail a committed limit where the program passes;
the int8 yardstick agrees with ``FlopCounterMode`` and with a hand count;
and the new readers give the values worked out by hand on a small trace."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import control_int8
import counting_int8
import devtrace
import run
from reference import lite, net

CELL = "msra21-lite-int8-batch1024"
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


def test_sound_run_is_correct():
    out = small_run()
    assert out["correct"] is True
    assert set(out["checks"]) == {"joints_off_1mm_pct", "worst_frame_gap_mm",
                                  "amax_gap_rel"}
    assert set(out["metrics"]) == {"setup_s", "frames_per_s"}


def test_traced_run_reads_the_int8_counter():
    """On the CPU the trace holds no kernels: the counter's metric is read,
    the device's are not; 53 standalone quantize steps a forward at s2/f16
    on 32x32 crops (29 residual sums, 4 hourglass sums, 20 convolutions of
    a float input)."""
    out = small_run(trace=True)
    assert out["correct"] is True
    assert out["metrics"]["quantize_calls.batch_int8"]["value"] == 53
    assert out["metrics"]["mfu.batch_int8"]["value"] > 0


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
    calibration: it serves the float lite net."""
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
    prog = control_int8.readings(CELL, 5, "program", "cpu", SMALL,
                                 SMALL_TRAFFIC)
    assert not fails(prog["program"])
    ctl = control_int8.readings(CELL, 6, "control", "cpu", SMALL,
                                SMALL_TRAFFIC)
    assert set(ctl) == {"control_bf16_float", "control_7bit"}
    for side, r in ctl.items():
        assert {"joints_off_1mm_pct", "worst_frame_gap_mm"} & set(fails(r)), \
            side


@pytest.mark.parametrize("small", [False, True])
def test_forward_ops_match_flop_counter(small):
    cfg = dict(common.load_cell(CELL)[2], **(SMALL if small else {}))
    params, _ = lite.param_shapes(cfg)
    meta = {k: torch.empty(s, device="meta") for k, s in params.items()
            if "/bn/" not in k}
    for k, s in params.items():
        if k.endswith("/conv/kernel"):
            meta[k.replace("/kernel", "/bias")] = torch.empty(s[0],
                                                              device="meta")
    x = torch.empty((1, cfg["input_size"], cfg["input_size"], 1),
                    device="meta")
    with FlopCounterMode(display=False) as counter:
        lite.forward(lite.FloatForm(net.Ctx(meta, "eval")), cfg, x)
    assert counting_int8.forward_ops(cfg) == counter.get_total_flops()
    if not small:
        assert round(counting_int8.forward_ops(cfg) / 1e9, 3) == 5.155
        kernels = [c["kernel"] for c in counting_int8.calls(cfg)]
        assert (kernels.count("k3"), kernels.count("dw")) == (105, 41)


def test_call_bytes_by_hand():
    """At batch 256: ``um_resA_s0/conv1`` (1x1, 170 -> 85 at 32x32, int8
    out) and its depthwise ``conv2`` (85 channels, 3x3, int8 out), and
    ``um_head_s1`` (1x1, 512 -> 63, float32 out)."""
    cfg = common.load_cell(CELL)[2]
    calls = {c["path"]: c for c in counting_int8.calls(cfg, 256)}
    px = 256 * 32 * 32
    k3 = calls["um_resA_s0/conv1"]
    assert k3["kernel"] == "k3"
    assert k3["bytes"] == px * 170 + 170 * 85 + 8 * 85 + px * 85
    assert k3["ops"] == 2 * px * 85 * 170
    dw = calls["um_resA_s0/conv2"]
    assert dw["kernel"] == "dw"
    assert dw["bytes"] == px * 85 + 9 * 85 + 8 * 85 + px * 85
    assert dw["ops"] == 2 * px * 85 * 9
    head = calls["um_head_s1"]
    assert head["bytes"] == px * 512 + 512 * 63 + 8 * 63 + px * 63 * 4


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr, name, start, dur):
    return [ev("cuda_runtime", "cudaLaunchKernel", ts, 1, corr),
            ev("kernel", name, start, dur, corr)]


# Two dispatches in a window of [0, 1000) µs: K3 kernels 100 + 60 µs, DW
# kernels 30 + 10 µs, and quantize spans that launch kernels of 5 + 7 µs
# (and one outside the window, not counted).
TRACE = (
    [ev("user_annotation", "bench.window", 0, 1000),
     ev("user_annotation", "densereg.dispatch", 0, 400),
     ev("user_annotation", "densereg.dispatch", 500, 400),
     ev("user_annotation", "densereg.int8.quantize", 10, 20),
     ev("user_annotation", "densereg.int8.quantize", 510, 20),
     ev("user_annotation", "densereg.int8.quantize", 1100, 20)]
    + launch(12, 1, "elementwise_kernel", 40, 5)
    + launch(515, 2, "elementwise_kernel", 540, 7)
    + launch(1105, 3, "elementwise_kernel", 1130, 9)
    + launch(50, 4, "void (anonymous namespace)::k3_kernel(Args)", 60, 100)
    + launch(560, 5, "void (anonymous namespace)::k3_kernel(Args)", 600, 60)
    + launch(200, 6, "void (anonymous namespace)::dw_kernel<3, 8, 32>"
             "(CUtensorMap_st, Args)", 200, 30)
    + launch(700, 7, "void (anonymous namespace)::dw_kernel<3, 8, 8>"
             "(CUtensorMap_st, Args)", 700, 10))


def test_readers_on_known_kernels(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": TRACE}))
    cfg = common.load_cell(CELL)[2]
    r = common.Run(cfg, {}, devtrace.Trace(str(path)),
                   counts={"dispatches": 2, "frames": 512,
                           "decode_batch": 256})
    per_forward = {"k3": 160e-6 / 2, "dw": 40e-6 / 2}
    for kernel in ("k3", "dw"):
        want = 100.0 * counting_int8.bound_s(cfg, kernel, 256) / \
            per_forward[kernel]
        assert common.reader(f"{kernel}_roofline.batch_int8")(r) == \
            pytest.approx(want, rel=1e-12)
    assert common.reader("quantize_ms.batch_int8")(r) == pytest.approx(
        (5 + 7) / 2 / 1e3, rel=1e-12)
    assert common.reader("mfu.batch_int8")(r) == pytest.approx(
        100.0 * counting_int8.forward_ops(cfg) * 512 / (1e-3 * 1979e12),
        rel=1e-12)
    bare = common.Run(cfg, {}, devtrace.Trace(str(path)))
    for name in ("k3_roofline.batch_int8", "dw_roofline.batch_int8",
                 "mfu.batch_int8", "quantize_calls.batch_int8"):
        assert common.reader(name)(bare) is None
    assert common.reader("quantize_calls.batch_int8")(common.Run(
        cfg, {}, counters={"quantize": 690, "forwards": 10})) == 69
