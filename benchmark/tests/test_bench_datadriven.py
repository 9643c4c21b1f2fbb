"""A later change adds a configuration, a traffic mix and a per-layer
metric by adding files and entries alone: in a copy of the benchmark, a
new configuration file, a new traffic file of an existing kind and a new
metric reader, with their entries in ``BENCHMARK.json``, run as a new cell
without a line of the harness edited."""

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)

SCRIPT = """
import json, sys
sys.path.insert(0, "benchmark"); sys.path.append(%r)
import torch; torch.set_num_threads(2)
import run
small = dict(num_stack=1, num_fea=8, input_size=32, output_size=8)
print(json.dumps(run.run_cell("extra-icvl-batch16", 9, 1, True,
                              device="cpu", config_overrides=small)))
"""


def snapshot(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in d}


def test_new_cell_config_traffic_and_metric_by_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    before = snapshot(root / "benchmark")
    spec = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
    cfg = json.load(open(os.path.join(CHECKOUT,
                                      spec["configs"][1]["file"])))
    json.dump(dict(cfg, num_joint=21),
              open(root / "benchmark/configs/extra.json", "w"))
    json.dump({"kind": "batch", "pool_frames": 24, "request_frames": 16,
               "request_sets": 2, "max_batch": 8, "trace_skip_requests": 0,
               "trace_requests": 2},
              open(root / "benchmark/traffic/batch16.json", "w"))
    (root / "benchmark/metrics/dispatches.extra.py").write_text(
        "def read(run):\n    return run.counts.get('dispatches')\n")
    spec["configs"].append({"name": "extra", "source": "https://example.org",
                            "file": "benchmark/configs/extra.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "extra-icvl-batch16", "config": "extra",
                              "traffic": "batch16", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][1]["workloads"].append("extra-icvl-batch16")
    spec["per_layer"].append({"name": "dispatches.extra", "unit": "calls",
                              "better": "lower", "source": "program_counter",
                              "layer": "a test", "moves": "frames_per_s",
                              "workloads": ["extra-icvl-batch16"]})
    json.dump(spec, open(root / "BENCHMARK.json", "w"))
    proc = subprocess.run([sys.executable, "-c", SCRIPT % CHECKOUT],
                          cwd=str(root), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["dispatches.extra"]["value"] == 4
    assert "mfu.batch" not in result["metrics"]    # that metric lists its cells
    after = snapshot(root / "benchmark")
    assert {p: after[p] for p in before} == before     # nothing edited
