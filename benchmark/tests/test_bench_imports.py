"""Nothing under ``benchmark/`` imports JAX, Flax or the JAX package, and
nothing in ``benchmark/reference/`` imports the measured package; module
names are compared by their top-level name, whole (the port's name begins
with the JAX package's)."""

import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "densereg_tpu"}


def sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources(os.path.join(BENCH,
                                                             "reference"))),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "contextlib", "typing", "math", "numpy", "torch"}
    assert set(top_level_imports(path)) <= allowed


def test_runner_names_loaded_jax_by_whole_top_level_name(monkeypatch):
    import sys
    import types

    import run

    monkeypatch.setitem(sys.modules, "densereg_tpu_like", types.ModuleType("x"))
    assert "densereg_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "densereg_tpu.serving",
                        types.ModuleType("y"))
    assert "densereg_tpu" in run.forbidden_modules()
