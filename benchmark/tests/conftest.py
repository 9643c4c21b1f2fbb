"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q``.

They import the harness's modules as ``benchmark/run.py`` does (the
benchmark's directory first on the path, the checkout last), and run
cells at a small size on the CPU through the runner's own entry."""

import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
if CHECKOUT not in sys.path:
    sys.path.append(CHECKOUT)

import torch  # noqa: E402

torch.set_num_threads(min(4, os.cpu_count() or 1))

# a small net and small traffic of each kind, for runs on the CPU
SMALL = dict(num_stack=1, num_fea=8, input_size=32, output_size=8)
SMALL_TRAFFIC = {
    "batch": dict(pool_frames=12, request_frames=8, request_sets=3,
                  max_batch=4,
                  trace_skip_requests=1, trace_requests=2),
    "train": dict(batch_size=4, sub_batch=2, pool_frames=48,
                  shard_frames=16),
    "cameras": dict(cameras=4, window_ms=50.0, pool_frames=8, max_batch=4,
                    batch_buckets=[1, 4], trace_delay_s=1, trace_s=1),
}

# The live-camera cell is not in BENCHMARK.json yet: its tails spread too
# widely between runs for a bound. Its harness runs; these entries, as a
# later change would add them, let the tests drive it through the runner.
CAMERAS = "nyu14-bf16-cameras30fps"
CAMERAS_ENTRIES = {
    "workloads": [
        {"name": CAMERAS, "config": "um_v1-s2f128-nyu14-bf16",
         "traffic": "cameras30fps", "chips": 1,
         "why": "open loop of 30 fps NYU cameras on the TCP daemon"}],
    "end_to_end": [
        {"name": "latency_p50_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": [CAMERAS]},
        {"name": "latency_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": [CAMERAS]}],
    "per_layer": [
        {"name": "batch_frames.live", "unit": "frames", "better": "higher",
         "source": "program_counter",
         "layer": "serving daemon (serve.Server batcher)",
         "moves": "latency_p95_ms", "workloads": [CAMERAS]},
        {"name": "idle_share.live", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device (H100)",
         "moves": "latency_p95_ms", "workloads": [CAMERAS]}],
}


def spec_with_cameras() -> dict:
    """``BENCHMARK.json`` with the camera cell's entries added."""
    import json

    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for k, extra in CAMERAS_ENTRIES.items():
        spec[k] = spec[k] + extra
    return spec
