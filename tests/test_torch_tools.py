"""The port's tools (``densereg_torch.tools``) against the JAX package's
(``tools/``) on the same inputs, on the CPU at a small size (s1/f8, 32
input where the tool takes a net config):

- ``compare_results``: two dumps written by the JAX package's
  ``ResultWriter``, in shuffled order: the same frames and per-frame
  maxima, mean and max within 1e-12 mm, the same fractions, byte-equal
  ``--curve_out`` files, the same exit codes on both sides of the
  ``--max_mean_delta`` gate;
- ``trace_summary``: a torch Chrome trace and the JAX-format trace of the
  same ops and durations give the same rows and total (both tools as
  subprocesses), the port's kernels named by their ids; a real CPU
  ``torch.profiler`` trace of a forward (``utils.profiling.trace_context``)
  read with ``--line cpu_op`` sums to the test's own sum of its events;
- ``serve_probe``: ``--net s1f8`` self-hosted on the CPU prints rows with
  the JAX probe's keys, and a 2-deep pipeline micro-batches;
- ``latency_probe``: ``build_program`` on ``bench._build``'s own weights
  and maps gives its xyz within the decode's 2e-4 normalized bound (0.02
  mm, ``PARITY.md``); the probe's last line has the JAX probe's keys.
"""

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

import jax  # noqa: E402

from densereg_tpu.eval.metrics import (  # noqa: E402
    summarize_percentages as jsummarize,
)
from densereg_tpu.eval.writer import ResultWriter  # noqa: E402

from densereg_torch.config import NetConfig  # noqa: E402
from densereg_torch.eval.metrics import summarize_percentages  # noqa: E402
from densereg_torch.tools import compare_results as tcompare  # noqa: E402
from densereg_torch.tools import latency_probe as tlatency  # noqa: E402
from densereg_torch.tools import serve_probe as tserve  # noqa: E402
from densereg_torch.tools import trace_summary as ttrace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from tools import compare_results as jcompare  # noqa: E402

XYZ_TOL_MM = 0.02     # the decode's 2e-4 normalized bound (PARITY.md)
PROBE_ARGV = ["--net", "s1f8", "--max_batch", "2", "--requests", "4",
              "--inflight", "1", "2", "--window_ms", "300"]
LATENCY_ARGV = ["--batches", "2", "--iters", "2", "--reps", "1"]


@pytest.fixture(scope="module", autouse=True)
def jax_serve_probe():
    """The JAX serve probe's output for ``PROBE_ARGV``, from a process of
    its own started with the module's first test (most of its time is
    building the JAX net at 128 input), read by the test that compares."""
    proc = subprocess.Popen(
        [sys.executable, "-c", "from tools.serve_probe import main; "
                               f"main({PROBE_ARGV!r})"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def read():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        return out

    try:
        yield read
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# --------------------------------------------------------------------------
# compare_results
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Two dumps of 40 frames x 16 joints, the second in another order and
    moved by about 2 mm a joint."""
    root = tmp_path_factory.mktemp("compare")
    rng = np.random.default_rng(7)
    names = [f"seq/frame_{i:03d}.png" for i in range(40)]
    xyz = rng.uniform(-80.0, 80.0, (40, 48)) + [0.0, 0.0, 400.0] * 16
    moved = xyz + rng.normal(0.0, 1.2, xyz.shape)
    a, b = str(root / "a.txt"), str(root / "b.txt")
    with ResultWriter(a) as w:
        w.write_batch(names, xyz)
    with ResultWriter(b) as w:
        order = rng.permutation(len(names))
        w.write_batch([names[i] for i in order], moved[order])
    return root, a, b


def _jax_main(monkeypatch, module, argv):
    """A JAX tool's ``main()``, which reads ``sys.argv``."""
    monkeypatch.setattr(sys, "argv", [module.__name__, *argv])
    return module.main()


def test_compare_results_matches_the_jax_tool(dumps):
    _, a, b = dumps
    ours, theirs = tcompare.compare(a, b), jcompare.compare(a, b)
    assert ours["frames"] == theirs["frames"] == 40
    assert np.array_equal(ours["per_frame_max"], theirs["per_frame_max"])
    for key in ("mean_joint_error_mm", "max_joint_error_mm"):
        assert abs(ours[key] - theirs[key]) <= 1e-12, key
    assert 1.0 < ours["mean_joint_error_mm"] < 4.0
    assert (summarize_percentages(ours["per_frame_max"])
            == jsummarize(theirs["per_frame_max"]))
    with pytest.raises(ValueError, match="absent from"):
        tcompare.compare(a, _drop_last_line(a))


def _drop_last_line(path):
    short = path + ".short"
    with open(path) as f, open(short, "w") as g:
        g.writelines(f.readlines()[:-1])
    return short


@pytest.mark.parametrize("side", ["under_the_gate", "over_the_gate"])
def test_compare_results_command_matches_the_jax_tool(dumps, monkeypatch,
                                                      capsys, side):
    """The printed lines, the ``--curve_out`` file byte for byte and the
    gate's exit code on each side of the mean error."""
    root, a, b = dumps
    mean = tcompare.compare(a, b)["mean_joint_error_mm"]
    gate = str(mean + 0.01 if side == "under_the_gate" else mean - 0.01)
    mine, theirs = str(root / f"{side}_t.txt"), str(root / f"{side}_j.txt")
    code = tcompare.main([a, b, "--curve_out", mine, "--max_mean_delta",
                          gate])
    out = capsys.readouterr().out
    jcode = _jax_main(monkeypatch, jcompare,
                      [a, b, "--curve_out", theirs, "--max_mean_delta", gate])
    jout = capsys.readouterr().out
    assert code == jcode == (0 if side == "under_the_gate" else 1)
    assert out.replace(mine, "CURVE") == jout.replace(theirs, "CURVE")
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()


# --------------------------------------------------------------------------
# trace_summary
# --------------------------------------------------------------------------

# (name, durations in us); one of the port's kernels and one of PyTorch's
OPS = [("fused_decode_kernel(View4, View4, View4, View4, float const*)",
        [30.5, 29.25]),
       ("void k3_kernel<128, 2>(Args)", [400.0, 250.0, 100.125]),
       ("void at::native::elementwise_kernel<128, 4>(int)", [12.0] * 4)]


def _torch_trace(ops):
    events = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "python"}}]
    ts = 0.0
    for name, durs in ops:
        for dur in durs:
            events.append({"ph": "X", "cat": "kernel", "name": name,
                           "pid": 0, "tid": 7, "ts": ts, "dur": dur})
            # the launch on the host, which the kernel line leaves out
            events.append({"ph": "X", "cat": "cuda_runtime",
                           "name": "cudaLaunchKernel", "pid": 1, "tid": 1,
                           "ts": ts, "dur": 5000.0})
            ts += dur + 1.0
    return {"deviceProperties": [{"id": 0, "name": "a card"}],
            "traceEvents": events}


def _jax_trace(ops):
    events = [
        {"ph": "M", "pid": 3, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 3, "tid": 1, "name": "thread_name",
         "args": {"name": "XLA Ops"}},
        {"ph": "M", "pid": 7, "name": "process_name",
         "args": {"name": "/host:CPU"}},
        {"ph": "M", "pid": 7, "tid": 1, "name": "thread_name",
         "args": {"name": "XLA Ops"}}]
    ts = 0.0
    for name, durs in ops:
        for dur in durs:
            events.append({"ph": "X", "pid": 3, "tid": 1, "name": name,
                           "ts": ts, "dur": dur})
            events.append({"ph": "X", "pid": 7, "tid": 1, "name": "host",
                           "ts": ts, "dur": 5000.0})
            ts += dur + 1.0
    return {"traceEvents": events}


def _table(out, columns):
    """``(total line, rows)`` of a summary: each row split into
    ``columns`` fields, the name last."""
    lines = out.splitlines()
    total = next(line for line in lines if "total" in line)
    rows = [line.split(None, columns - 1) for line in lines
            if line and not line.startswith("#") and "ms/step" not in line]
    return total.rsplit("total", 1)[1], rows


@pytest.mark.parametrize("suffix", [".pt.trace.json", ".pt.trace.json.gz"])
def test_trace_summary_matches_the_jax_tool(tmp_path, suffix):
    mine = tmp_path / "torch" / "run" / f"host_1{suffix}"
    mine.parent.mkdir(parents=True)
    opener = gzip.open if suffix.endswith(".gz") else open
    with opener(mine, "wt") as f:
        json.dump(_torch_trace(OPS), f)
    theirs = tmp_path / "jax" / "plugins" / "profile" / "x"
    theirs.mkdir(parents=True)
    with gzip.open(theirs / "vm.trace.json.gz", "wt") as f:
        json.dump(_jax_trace(OPS), f)

    def run(*cmd):
        out = subprocess.run([sys.executable, *cmd, "--steps", "2"],
                             capture_output=True, text=True, cwd=ROOT,
                             timeout=120)
        assert out.returncode == 0, out.stderr
        return out.stdout

    total, rows = _table(run("-m", "densereg_torch.tools.trace_summary",
                             str(tmp_path / "torch")), 5)
    jtotal, jrows = _table(run("tools/trace_summary.py",
                               str(tmp_path / "jax")), 4)
    assert total == jtotal == " 0.43 ms/step"
    assert [r[:3] + r[4:] for r in rows] == jrows
    assert [r[3] for r in rows] == ["K3", "K1", "-"]
    assert rows[0][2] == "1"     # 3 calls over 2 steps, as the JAX tool


def test_trace_summary_reads_a_real_cpu_trace(tmp_path, capsys):
    from densereg_torch.models import from_flax, init_variables
    from densereg_torch.utils.profiling import trace_context

    cfg = NetConfig(num_stack=1, num_fea=8, num_joint=16, input_hw=(32, 32))
    net = from_flax(init_variables(cfg, seed=1), cfg)
    with torch.inference_mode(), trace_context(str(tmp_path / "trace")):
        net(torch.zeros(2, 32, 32, 1))
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    want_us = sum(e["dur"] for e in events)
    assert len(events) > 50 and want_us > 0

    rows, total, devices = ttrace.summarize(ttrace.load_trace(str(path)),
                                            "cpu_op")
    assert total == pytest.approx(want_us, rel=1e-12)
    assert sum(n for _, _, n in rows) == len(events)
    assert devices == ["host"]
    assert ttrace.main([str(tmp_path), "--line", "cpu_op", "--top",
                        "1000"]) == 0
    out = capsys.readouterr().out
    assert f"total {want_us / 1000:.2f} ms/step" in out
    _, printed = _table(out, 5)
    assert len(printed) == len(rows)
    assert {r[3] for r in printed} == {"-"}
    assert "aten::conv2d" in {r[4] for r in printed}


# --------------------------------------------------------------------------
# latency_probe
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bench_small():
    """``bench`` at s1/f8/J16, 32 input (its module variables, which
    ``_build`` reads when called)."""
    import bench

    saved = {k: getattr(bench, k) for k in ("STACK", "FEA", "JOINT",
                                            "INPUT")}
    bench.STACK, bench.FEA, bench.JOINT, bench.INPUT = 1, 8, 16, 32
    yield bench
    for k, v in saved.items():
        setattr(bench, k, v)


def test_build_program_matches_bench_build(bench_small):
    b = 6
    infer, variables, dms, cfgs, coms = bench_small._build(b, "float32")
    want = np.asarray(infer(variables, dms, cfgs, coms))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    cfg = NetConfig(num_stack=1, num_fea=8, num_joint=16, input_hw=(32, 32))
    tinfer, net, tdms, tcfgs, tcoms = tlatency.build_program(
        b, "float32", False, cfg, "cpu", variables=tree)
    assert np.array_equal(tdms.numpy(), np.asarray(dms))
    np.testing.assert_allclose(tcfgs.numpy(), np.asarray(cfgs), rtol=1e-6)
    assert np.array_equal(tcoms.numpy(), np.asarray(coms))
    got = tinfer(net, tdms, tcfgs, tcoms).numpy()
    assert got.shape == want.shape == (b, 48)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= XYZ_TOL_MM


def test_latency_probe_line_matches_the_jax_probe(bench_small, monkeypatch,
                                                  capsys):
    from tools import latency_probe as jlatency

    assert tlatency.main([*LATENCY_ARGV, "--net", "s1f8", "--device",
                          "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    _jax_main(monkeypatch, jlatency, LATENCY_ARGV)
    jout = capsys.readouterr().out.splitlines()
    mine, theirs = json.loads(out[-1]), json.loads(jout[-1])
    assert mine.keys() == theirs.keys()
    assert mine["metric"] == theirs["metric"] == "serving latency sweep"
    assert [r.keys() for r in mine["rows"]] == [r.keys()
                                                for r in theirs["rows"]]
    assert [r["batch"] for r in mine["rows"]] == [2]
    assert all(r["latency_ms"] > 0 and r["fps"] > 0 for r in mine["rows"])
    assert out[0].startswith("device: cpu") and "float32" in out[0]
    assert len(out) == len(jout)


# --------------------------------------------------------------------------
# serve_probe
# --------------------------------------------------------------------------

def _rows(out):
    return [json.loads(r) for r in out.splitlines() if r.startswith("{")]


def test_serve_probe_rows_match_the_jax_probe(capsys, jax_serve_probe):
    """``--window_ms 300``: a 2-deep pipeline must coalesce on a loaded
    host, as ``tests/test_serve.py::test_serve_probe_net_mode`` holds the
    JAX probe."""
    assert tserve.main([*PROBE_ARGV, "--device", "cpu"]) == 0
    mine = _rows(capsys.readouterr().out)
    theirs = _rows(jax_serve_probe())
    assert len(mine) == len(theirs) == 2
    for depth, row, jrow in zip((1, 2), mine, theirs):
        assert row.keys() == jrow.keys()
        assert row["inflight"] == depth and row["requests"] == 4
        assert row["fps"] > 0 and row["p99_ms"] >= row["p50_ms"]
    assert mine[0]["row_mean_batch"] == 1.0
    assert mine[1]["row_mean_batch"] > 1.0
    assert mine[1]["server_mean_batch"] > 1.0


def test_serve_probe_refuses_without_a_server_or_a_card(capsys):
    with pytest.raises(SystemExit):
        tserve.main(["--requests", "4"])
    assert "need --socket, --artifact, or --net" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no visible cuda device"):
            tserve.main(["--net", "s1f8", "--requests", "1"])
    with pytest.raises(SystemExit, match="s2f128"):
        tserve.net_config("f8")
