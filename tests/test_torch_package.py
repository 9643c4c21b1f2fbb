"""densereg_torch stands alone: it imports neither JAX, Flax nor the JAX
package, and its CUDA entry points raise rather than fall back."""

import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

PKG = pathlib.Path(__file__).resolve().parent.parent / "densereg_torch"
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "densereg_tpu"}


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [PKG.parent / "chip_smoke.py"],
                         ids=lambda p: (str(p.relative_to(PKG))
                                        if PKG in p.parents else p.name))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(_imported_roots(path)) & BANNED


@pytest.mark.parametrize("name", ["ops/int8_gemm.py", "ops/meanshift.py",
                                  "models/quantize.py", "models/layers.py",
                                  "models/bridge.py", "serving.py"])
def test_int8_and_meanshift_modules_are_checked(name):
    """The int8 path's modules and K2's exist where the import check above
    looks, each kernel wrapper beside its CUDA source."""
    assert (PKG / name).is_file()
    if name.startswith("ops/"):
        assert (PKG / "csrc" / (pathlib.Path(name).stem + ".cu")).is_file()


@pytest.mark.parametrize("name", [
    "targets.py", "augment.py", "preprocess.py", "train/losses.py",
    "train/lr.py", "train/state.py", "train/step.py", "train/checkpoint.py",
    "train/loop.py", "data/base.py", "data/synthetic.py", "data/pipeline.py",
    "eval/metrics.py", "utils/logging.py", "utils/profiling.py"])
def test_training_modules_are_checked(name):
    """The training slice's modules exist where the import checks above
    and below look."""
    assert (PKG / name).is_file()


@pytest.mark.parametrize("name", [
    "eval/writer.py", "eval/loop.py", "convert.py", "data/png16.py",
    "data/native.py", "data/icvl.py", "data/nyu.py", "data/msra.py",
    "data/bighand.py", "data/mixed.py"])
def test_evaluation_modules_are_checked(name):
    """The evaluation slice's modules exist where the import checks above
    and below look; the dataset registry knows every reader."""
    assert (PKG / name).is_file()
    from densereg_torch.data import get_dataset

    with pytest.raises(ValueError, match=r"has \['bighand', 'icvl', 'msra', "
                                         r"'nyu', 'synthetic'\]"):
        get_dataset("kinect", "training")


@pytest.mark.parametrize("name", [
    "serve.py", "wire.py", "utils/tb.py", "eval/visualization.py"])
def test_tooling_and_daemon_modules_are_checked(name):
    """The copies of the JAX package's numpy-only modules (the daemon, the
    wire codec, the event files, the figures) exist where the import checks
    look."""
    assert (PKG / name).is_file()


@pytest.mark.parametrize("name", [
    "export.py", "parallel/__init__.py", "parallel/mesh.py",
    "parallel/distributed.py", "utils/device.py"])
def test_export_and_parallel_modules_are_checked(name):
    """The export and multi-GPU modules exist where the import checks
    look; the device shim picks a card unless asked for the CPU."""
    import inspect

    assert (PKG / name).is_file()
    from densereg_torch.parallel import make_mesh
    from densereg_torch.utils.device import default_device, visible_devices

    assert inspect.signature(default_device).parameters[
        "platform"].default == "cuda"
    assert visible_devices("cpu") == [torch.device("cpu")]
    assert make_mesh(devices=["cpu"]).devices == (torch.device("cpu"),)


@pytest.mark.parametrize("name", [
    "compare_results", "trace_summary", "serve_probe", "latency_probe"])
def test_tools_modules_are_checked(name):
    """The port's tools lie where the import checks look, import without
    touching a card (every CUDA query raises in the process) and print
    their help; the probes default to the card."""
    assert (PKG / "tools" / f"{name}.py").is_file()
    code = (
        "import sys, torch\n"
        "def card(*a, **k):\n"
        "    raise AssertionError('a card was touched')\n"
        "for f in ('is_available', 'device_count', 'init', '_lazy_init',\n"
        "          'current_device', 'get_device_name'):\n"
        "    setattr(torch.cuda, f, card)\n"
        f"from densereg_torch.tools import {name}\n"
        f"sys.exit({name}.main(['--help']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("usage:")
    if name.endswith("_probe"):
        assert "--device {cuda,cpu}" in out.stdout


def _top_level_roots(path: pathlib.Path):
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Try):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Import):
                    yield from (a.name.split(".")[0] + "?" for a in sub.names)


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [PKG.parent / "chip_smoke.py"],
                         ids=lambda p: (str(p.relative_to(PKG))
                                        if PKG in p.parents else p.name))
def test_drawing_libraries_are_imported_where_they_draw(path):
    """matplotlib, cv2 and google_crc32c are not on every machine that runs
    the port (the card's has none of them): no module imports them when it
    is imported, but inside the functions that draw, or behind a
    fallback."""
    roots = set(_top_level_roots(path))
    assert not roots & {"matplotlib", "cv2", "google_crc32c"}


def test_imports_with_jax_blocked():
    """Every module of the package imports in a process where importing
    JAX, Flax or the JAX package fails."""
    code = (
        "import sys, pkgutil, importlib\n"
        f"for name in {sorted(BANNED)!r}:\n"
        "    sys.modules[name] = None\n"
        "import densereg_torch\n"
        "for m in pkgutil.walk_packages(densereg_torch.__path__, "
        "'densereg_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k.split('.')[0] in ('jax', 'flax', 'densereg_tpu') "
        "and sys.modules[k] is not None for k in sys.modules)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_cuda():
    import inspect

    from densereg_torch import Predictor
    from densereg_torch.data import InputPipeline, TestPipeline
    from densereg_torch.data.mixed import MixedPipeline
    from densereg_torch.eval import make_infer_fn
    from densereg_torch.train import create_train_state, loop, train

    for fn in (Predictor.__init__, make_infer_fn, train, create_train_state,
               InputPipeline.__init__, TestPipeline.__init__, loop.test,
               MixedPipeline.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    # from_checkpoint and from_converted hand their keywords, device
    # included, to __init__
    for fn in (Predictor.from_checkpoint, Predictor.from_converted):
        params = inspect.signature(fn).parameters
        assert "device" not in params and "kwargs" in params


def test_library_name_hashes_included_headers(tmp_path, monkeypatch):
    """An edited header under ``csrc/`` (included directly or through
    another header) renames the library, so it is rebuilt, never stale."""
    from densereg_torch.ops import _build

    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "k.cu").write_text(
        '#include <cuda_runtime.h>\n#include "a.cuh"\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build.local_headers(tmp_path / "k.cu")] == [
        "a.cuh", "b.cuh"]
    first = _build.library_path("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build.library_path("k") != first
    monkeypatch.undo()
    assert set(_build.sources()) >= {"fused_decode", "int8_gemm", "meanshift"}
    assert all(_build.library_path(n).suffix == ".so" for n in _build.sources())


JAX_PKG = PKG.parent / "densereg_tpu"
# Public names of the JAX package whose counterpart in the port has another
# name or lives in another module: "module::name" -> ("module::name", why)
RENAMED = {
    "ops/int8_gemm.py::reference_gemm_requant": (
        "ops/int8_gemm.py::int8_gemm_requant_reference",
        "K3's plain version, named after the kernel it checks, as every "
        "plain version of the port's kernels is"),
    "train/step.py::train_step_single": (
        "train/step.py::train_step",
        "nothing is jitted: one eager function is the step, with the "
        "gradient all-reduce of a group where JAX had axis_name"),
    "train/step.py::make_train_step": (
        "train/step.py::train_step",
        "make_train_step jits and shards the JAX step; the eager step needs "
        "no factory (make_fused_train_step is the port's fused form)"),
    "data/pipeline.py::device_prefetch": (
        "data/pipeline.py::InputPipeline",
        "the pipeline copies each batch from pinned memory without "
        "blocking, behind the running step, so no lookahead wrapper is "
        "needed"),
    "ops/meanshift_pallas.py::weighted_mean_shift_pallas": (
        "ops/meanshift.py::weighted_mean_shift_cuda",
        "K2, the same stage as a hand-written CUDA kernel"),
    "ops/meanshift_pallas.py::GRID": (
        "ops/fused_decode.py::GRID",
        "the vote grid, one constant for the decode's kernels"),
    "ops/meanshift_pallas.py::NUM_CELLS": (
        "ops/fused_decode.py::NUM_CELLS",
        "the vote grid's cells, one constant for the decode's kernels"),
    "ops/meanshift_pallas.py::TILE_M": (
        "ops/meanshift.py::MAX_CANDIDATES",
        "the Pallas kernel tiles 512 problems on the lanes of a grid step; "
        "the CUDA kernel gives each problem one 8-lane segment, so its "
        "launch is bounded by the candidates a problem"),
}


def _public_names(path: pathlib.Path):
    """Top-level public functions, classes and UPPER constants."""
    out = set()
    for node in ast.parse(path.read_text(), str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out |= {t.id for t in targets if isinstance(t, ast.Name)
                    and t.id.isupper()}
    return {n for n in out if not n.startswith("_")}


def test_every_public_name_has_a_counterpart():
    """Every public function, class and UPPER constant of every module of
    the JAX package is defined in the port's module of the same path, or
    ``RENAMED`` names where its counterpart lives and why; every entry of
    ``RENAMED`` names a JAX name and a port name that exist."""
    missing = []
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        port = PKG / rel
        have = _public_names(port) if port.is_file() else set()
        for name in sorted(_public_names(path) - have):
            if f"{rel}::{name}" not in RENAMED:
                missing.append(f"{rel}::{name}")
    assert not missing, missing
    for key, (target, why) in RENAMED.items():
        jmod, jname = key.split("::")
        tmod, tname = target.split("::")
        assert jname in _public_names(JAX_PKG / jmod), key
        assert tname in _public_names(PKG / tmod), target
        assert len(why) > 20, key


def test_cli_and_convert_main_exist():
    """The command line and the converter's command line, where the import
    checks above look."""
    from densereg_torch import convert
    from densereg_torch.cli import main

    assert callable(convert.main) and callable(main.main)
    assert (PKG / "cli" / "__init__.py").is_file()
