"""The trace reader on a small hand-made Chrome trace: the window, busy
time as the union of device events, kernels joined to a host range by
correlation id, and idle gaps named by the innermost host event of any
launching thread."""

import json

import devtrace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reader(tmp_path):
    events = [
        ev("user_annotation", "bench.window", 0, 100),
        ev("user_annotation", "bench.net", 10, 20),
        ev("cpu_op", "aten::conv", 10, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 60, 1, tid=2, corr=3),
        ev("cpu_op", "aten::copy_", 45, 10),
        ev("cpu_op", "backward_op", 70, 20, tid=2),
        ev("kernel", "conv_kernel", 15, 10, corr=1),
        ev("kernel", "add_kernel", 20, 10, corr=2),
        ev("gpu_memcpy", "Memcpy HtoD", 60, 5),
        ev("kernel", "late_kernel", 200, 5, corr=3),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    t = devtrace.Trace(str(path))
    assert t.window_s == 100e-6
    assert abs(t.busy_s - 20e-6) < 1e-12       # [15, 30) and [60, 65)
    assert [k["name"] for k in t.kernels_launched_in("bench.net")] == [
        "conv_kernel"]
    assert abs(t.seconds("gpu_memcpy", "HtoD") - 5e-6) < 1e-12
    b = t.breakdown()
    assert b["device_ops"][0][0] in ("conv_kernel", "add_kernel")
    gaps = dict(b["idle_gaps"])
    assert abs(gaps["aten::copy_"] - 30e-6) < 1e-12     # [30, 60)
    assert abs(gaps["backward_op"] - 35e-6) < 1e-12     # [65, 100)
    assert abs(gaps["no host event"] - 15e-6) < 1e-12   # [0, 15)
