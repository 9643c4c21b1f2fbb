"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and lengths, each cell's configuration, traffic and metrics, a
reader for every per-layer metric, the bounds, and the run length that a
full check of 24 cells fits."""

import json
import os
import re

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(BENCH)
SPEC = json.load(open(os.path.join(CHECKOUT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert all(line(w) for w in SPEC["command"])
    assert os.path.getsize(os.path.join(CHECKOUT, "BENCHMARK.json")) < 65536
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and c["name"] in used
        assert os.path.isfile(os.path.join(CHECKOUT, c["file"]))
        assert c["reduced"] == []
    assert len({c["file"] for c in SPEC["configs"]}) == len(names)


def test_workloads():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1 and line(w["why"])
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for c in cells:
        reported = [m for m in SPEC["end_to_end"]
                    if c in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(c in m.get("workloads", []) for m in SPEC["per_layer"])


@pytest.mark.parametrize("name", sorted(
    {w["traffic"] for w in SPEC["workloads"]}))
def test_traffic_is_data_of_a_known_kind(name):
    tr = json.load(open(os.path.join(BENCH, "traffic", name + ".json")))
    assert os.path.isfile(os.path.join(BENCH, "drivers", tr["kind"] + ".py"))


def test_camera_cell_entries_name_what_exists():
    """The camera cell's entries, as the tests add them
    (``conftest.CAMERAS_ENTRIES``), name a configuration, a traffic file
    and readers that exist, and no name the benchmark already uses."""
    from conftest import CAMERAS_ENTRIES

    configs = {c["name"] for c in SPEC["configs"]}
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for w in CAMERAS_ENTRIES["workloads"]:
        assert w["config"] in configs and NAME.match(w["name"])
        assert w["name"] not in {c["name"] for c in SPEC["workloads"]}
        assert os.path.isfile(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    for m in CAMERAS_ENTRIES["end_to_end"] + CAMERAS_ENTRIES["per_layer"]:
        assert m["name"] not in names and UNIT.match(m["unit"])
    for m in CAMERAS_ENTRIES["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
