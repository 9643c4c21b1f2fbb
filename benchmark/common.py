"""What every cell shares: finding a cell's configuration, traffic mix and
metric readers by the names in ``BENCHMARK.json``; the program's
configuration objects built from a configuration file; the comparison
statistics; and the record that metric readers read.

A configuration is ``benchmark/<file>`` as ``BENCHMARK.json`` names it, a
traffic mix ``benchmark/traffic/<traffic>.json``, a per-layer metric's
reader ``benchmark/metrics/<metric name>.py`` (a function ``read(run)``
that returns a number, or None where it finds nothing to read).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

BENCH = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(BENCH)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_parts(config: str, traffic: str, spec: Optional[dict] = None
               ) -> Tuple[dict, dict]:
    """``(config, traffic)``: the configuration file that ``BENCHMARK.json``
    gives the configuration ``config``, and ``traffic/<traffic>.json``."""
    spec = spec or load_json(os.path.join(CHECKOUT, "BENCHMARK.json"))
    confs = {c["name"]: c for c in spec["configs"]}
    if config not in confs:
        raise SystemExit(f"no configuration {config!r} in BENCHMARK.json; "
                         f"configurations: {sorted(confs)}")
    return (load_json(os.path.join(CHECKOUT, confs[config]["file"])),
            load_json(os.path.join(BENCH, "traffic", traffic + ".json")))


def load_cell(name: str, spec: Optional[dict] = None
              ) -> Tuple[dict, dict, dict, dict]:
    """``(spec, workload, config, traffic)`` of the cell ``name`` of
    ``BENCHMARK.json`` (or of ``spec``)."""
    spec = spec or load_json(os.path.join(CHECKOUT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"cells: {sorted(cells)}")
    work = cells[name]
    config, traffic = load_parts(work["config"], work["traffic"], spec)
    return spec, work, config, traffic


def metrics_of(spec: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those that list it, and those without a list whose end-to-end metric
    it reports."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


def reader(name: str) -> Callable:
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What one run hands its metric readers: the configuration and the
    traffic, the parsed trace of the traced window (None without one), the
    program's counters over the window, and counts of the work the traced
    window completed."""

    config: dict
    traffic: dict
    trace: Any = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)


def net_config(config: dict):
    """The program's ``NetConfig`` for a configuration file."""
    from densereg_torch.config import NetConfig

    return NetConfig(
        num_stack=config["num_stack"], num_fea=config["num_fea"],
        kernel_size=config["kernel_size"], num_joint=config["num_joint"],
        input_hw=(config["input_size"], config["input_size"]),
        net_module=config["net_module"],
        compute_dtype=config["compute_dtype"],
        bn_epsilon=config["bn_epsilon"], bn_decay=config["bn_decay"],
        renorm_t_delta=config["renorm_t_delta"],
        dropout_rate=config["dropout_rate"])


def camera(config: dict):
    from densereg_torch.config import CameraConfig

    c = config["camera"]
    return CameraConfig(c["fx"], c["fy"], c["cx"], c["cy"], c["w"], c["h"])


def camera_tensor(config: dict, device):
    """The sensor's ``(fx, fy, cx, cy, w, h)`` as a float32 tensor."""
    import torch

    c = config["camera"]
    return torch.tensor([c[k] for k in ("fx", "fy", "cx", "cy", "w", "h")],
                        dtype=torch.float32, device=device)


def joint_gaps(xyz: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Per joint, the distance in mm between the program's and the
    reference's joint, ``(frames, joints)``."""
    a = np.asarray(xyz, np.float64).reshape(len(xyz), -1, 3)
    b = np.asarray(ref, np.float64).reshape(len(ref), -1, 3)
    return np.linalg.norm(a - b, axis=-1)


def serving_readings(gaps: np.ndarray) -> Dict[str, float]:
    """The numbers a serving cell compares, from ``(frames, joints)`` gaps:
    the share of joints more than 1 mm off, and the worst answer, the
    largest over frames of a frame's median joint gap (a vote that flips
    to another candidate on rounding moves one joint of a frame, not its
    median; a wrong answer moves them all)."""
    g = np.nan_to_num(gaps, nan=1e9)
    return {"joints_off_1mm_pct": float(100.0 * np.mean(g > 1.0)),
            "worst_frame_gap_mm": float(np.median(g, axis=1).max())
            if len(g) else 0.0}
