"""Run one benchmark cell once on this machine's GPUs and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program, ``densereg_torch``. The cell's configuration, traffic mix
and per-layer metric readers are found by the names ``BENCHMARK.json``
gives (``benchmark/common.py``); the traffic's ``kind`` names its driver,
``benchmark/drivers/<kind>.py``. Set-up runs from process start to the
window's start (``setup_s``); the window measures for ``--seconds``; once
it has closed, the peak device memory is read and what the window produced
is compared with the plain reference (``benchmark/reference``). With
``--trace 1`` a traced part of the window gives the per-layer metrics
instead of the end-to-end ones.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``, each number compared beside its limit,
which are also the last lines of standard error. Without a CUDA device, or
with fewer than the cell asks for, the run exits 2 and prints no result; if
JAX, Flax or the JAX package is loaded once the window has closed, it
exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "densereg_tpu")


def _cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = os.path.join(BENCH, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Cell:
    """One run of one cell: its settings, and the hooks a driver calls."""

    def __init__(self, name, seed, seconds, trace, config, traffic, device,
                 scratch):
        import torch

        self.torch = torch
        self.name, self.seed, self.seconds = name, seed, seconds
        self.trace, self.config, self.traffic = trace, config, traffic
        self.device = torch.device(device)
        self.scratch = scratch
        self.setup_s = None
        self.peak_bytes = 0
        self.parsed_trace = None
        self.limits = config["limits"][traffic["kind"]]

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def window_open(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - T_START

    def window_close(self) -> None:
        self.sync()
        if self.device.type == "cuda":
            self.peak_bytes = int(self.torch.cuda.max_memory_allocated(
                self.device))

    def warm_profiler(self) -> None:
        """Start and stop the profiler once in set-up, in a traced run: its
        first start loads and initialises the device tracer, seconds that
        would otherwise fall inside the window."""
        if self.trace:
            prof = self.start_profiler()
            self.torch.ones(1, device=self.device).add_(1)
            self.sync()
            prof.stop()

    def start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def stop_profiler(self, prof) -> None:
        self.sync()
        prof.stop()
        path = os.path.join(self.scratch, "window.pt.trace.json")
        prof.export_chrome_trace(path)
        self.load_trace(path)

    def load_trace(self, path: str) -> None:
        import devtrace

        self.parsed_trace = devtrace.Trace(path)

    def outcome(self, attempted, failed, end_to_end, readings, counts=None,
                counters=None) -> dict:
        return dict(attempted=attempted, failed=failed,
                    end_to_end=end_to_end, readings=readings,
                    counts=counts or {}, counters=counters or {})


def run_cell(name: str, seed: int, seconds: int, trace: bool,
             device: str = "cuda", spec=None, config_overrides=None,
             traffic_overrides=None) -> dict:
    """Run the cell and return its result line as a dict (``checks``
    last). ``spec`` and the overrides let a test run a cell at a small
    size on the CPU."""
    import common

    spec, work, config, traffic = common.load_cell(name, spec)
    config = dict(config, **(config_overrides or {}))
    traffic = dict(traffic, **(traffic_overrides or {}))
    with tempfile.TemporaryDirectory(prefix="bench-") as scratch:
        cell = Cell(name, seed, seconds, trace, config, traffic, device,
                    scratch)
        driver = importlib.import_module(f"drivers.{traffic['kind']}")
        out = driver.run(cell)
        checks = {k: {"value": v, "limit": cell.limits[k]}
                  for k, v in out["readings"].items()}
        correct = all(c["value"] <= c["limit"] for c in checks.values())
        run = common.Run(config, traffic, cell.parsed_trace,
                         out["counters"], out["counts"])
        metrics = {}
        if trace:
            for m in common.metrics_of(spec, name, "per_layer"):
                value = common.reader(m["name"])(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            values = dict(out["end_to_end"], setup_s=cell.setup_s)
            for m in common.metrics_of(spec, name, "end_to_end"):
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        result = {"correct": correct, "attempted": out["attempted"],
                  "failed": out["failed"], "metrics": metrics,
                  "device": device_info(cell, work["chips"])}
        if trace and cell.parsed_trace is not None:
            t = cell.parsed_trace
            result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
            result["breakdown"] = t.breakdown()
        result["checks"] = checks
        return result


def device_info(cell: Cell, chips: int) -> dict:
    torch = cell.torch
    if cell.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": cell.peak_bytes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    sys.path.append(CHECKOUT)
    import common

    spec, work, _, _ = common.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the GPU only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < work["chips"]:
        print(f"{args.workload} needs {work['chips']} GPUs, this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), spec=spec)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
