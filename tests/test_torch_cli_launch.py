"""The port's command line on a machine of several visible devices: ``train``
and ``test`` run one process a device in a local group
(``cli.main.launch_local_group``), as the JAX command line drives every
local chip (a declared difference, ``cli.main.DIFFERENCES``).

- the plan: with two visible devices, ``train`` and ``test`` start two
  children, each with the user's argv plus ``--coordinator_address``,
  ``--num_processes 2`` and its rank, 0 and 1, and each with its share of
  the cores in ``OMP_NUM_THREADS``;
- exit codes: a failing child makes the parent fail, and the other child
  is stopped;
- the card of a rank: the ``i``-th of ``DENSEREG_VISIBLE_DEVICES``;
- no launch with one device, with ``--no-mesh``, with
  ``--coordinator_address`` or ``DENSEREG_NUM_PROCESSES``, or for the
  subcommands that split over local cards in one process;
- end to end: one ``--device cpu`` ``train`` call on two (patched) CPU
  devices runs as two gloo children; rank 0 writes the checkpoint, with
  the tree of a one-process run of the same command, and rank 1 its own
  log; then one ``test`` call merges the two ranks' results.
"""

import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_torch.cli import main as tcli  # noqa: E402
from densereg_torch.data import get_dataset  # noqa: E402
from densereg_torch.parallel import distributed  # noqa: E402
from densereg_torch.utils import device as device_mod  # noqa: E402
from test_torch_cli_multiprocess import _flat  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
DESC = "synthetic_training_s1_f8_in32_daug_um_v1"


def _flags(data_dir="synth", base_dir="cache"):
    return ["--dataset", "synthetic", "--data_dir", data_dir,
            "--input_size", "32", "--batch_size", "8", "--sub_batch", "1",
            "--num_stack", "1", "--num_fea", "8",
            "--compute_dtype", "float32", "--base_dir", base_dir,
            "--device", "cpu"]


@pytest.fixture
def two_devices(monkeypatch):
    """This process sees two devices of every platform."""
    monkeypatch.setattr(device_mod, "visible_devices",
                        lambda platform="cuda": [torch.device("cpu")] * 2)
    monkeypatch.delenv("DENSEREG_NUM_PROCESSES", raising=False)


@pytest.fixture
def children(monkeypatch):
    """Records the commands and environment ``run_children`` is given."""
    runs = []

    def record(commands, env):
        runs.append((commands, env))
        return 0

    monkeypatch.setattr(tcli, "run_children", record)
    return runs


@pytest.mark.parametrize("cmd", ["train", "test"])
def test_train_and_test_start_one_child_a_device(two_devices, children,
                                                 monkeypatch, capsys, cmd):
    monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    argv = [cmd, *_flags(), "--max_steps", "1"] if cmd == "train" \
        else [cmd, *_flags()]
    assert tcli.main(argv) == 0
    ((commands, env),) = children
    assert len(commands) == 2
    coordinators = set()
    for rank, command in enumerate(commands):
        assert command[:3] == [sys.executable, "-m",
                               "densereg_torch.cli.main"]
        assert command[3:3 + len(argv)] == argv
        extra = command[3 + len(argv):]
        assert extra[0::2] == ["--coordinator_address", "--num_processes",
                               "--process_id"]
        assert extra[3] == "2" and extra[5] == str(rank)
        coordinators.add(extra[1])
    (coordinator,) = coordinators
    assert coordinator.startswith("127.0.0.1:")
    assert env["OMP_NUM_THREADS"] == str(max(1, (os.cpu_count() or 1) // 2))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == ROOT
    assert "one process a device" in capsys.readouterr().out


def test_the_user_threads_are_kept(two_devices, children, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert tcli.main(["test", *_flags()]) == 0
    assert children[0][1]["OMP_NUM_THREADS"] == "3"


@pytest.mark.parametrize("argv", [
    ["train", "--no-mesh"], ["test", "--no-mesh"],
    ["train", "--coordinator_address", "127.0.0.1:1", "--num_processes",
     "1", "--process_id", "0"],
    ["predict", "--images", "x"], ["serve", "--socket", "s"],
    ["export"]], ids=["train-no-mesh", "test-no-mesh", "coordinator",
                      "predict", "serve", "export"])
def test_no_child_where_the_command_runs_here(two_devices, argv):
    args = tcli.build_parser().parse_args([*argv, "--device", "cpu"])
    assert tcli.local_group_size(args) == 0


def test_no_child_on_one_device_or_under_the_environment(monkeypatch):
    parse = tcli.build_parser().parse_args
    monkeypatch.delenv("DENSEREG_NUM_PROCESSES", raising=False)
    assert tcli.local_group_size(parse(["train", "--device", "cpu"])) == 0
    monkeypatch.setattr(device_mod, "visible_devices",
                        lambda platform="cuda": [torch.device("cpu")] * 2)
    assert tcli.local_group_size(parse(["train", "--device", "cpu"])) == 2
    monkeypatch.setenv("DENSEREG_NUM_PROCESSES", "2")
    assert tcli.local_group_size(parse(["train", "--device", "cpu"])) == 0


def test_main_runs_here_without_a_launch(two_devices, monkeypatch):
    """``--no-mesh`` and ``--coordinator_address`` run the subcommand in
    this process (the group joined by ``initialize_distributed``)."""
    ran, joined = [], []

    def fail(*a):
        raise AssertionError("no child expected")

    monkeypatch.setattr(tcli, "run_children", fail)
    monkeypatch.setattr(tcli, "cmd_train", lambda args: ran.append(args)
                        or 0)
    import densereg_torch.parallel as parallel

    monkeypatch.setattr(parallel, "initialize_distributed",
                        lambda *a, **kw: joined.append((a, kw)))
    assert tcli.main(["train", "--no-mesh", "--device", "cpu"]) == 0
    assert tcli.main(["train", "--device", "cpu", "--coordinator_address",
                      "127.0.0.1:9", "--num_processes", "2",
                      "--process_id", "1"]) == 0
    assert len(ran) == 2
    assert joined == [(("127.0.0.1:9", 2, 1), {"backend": "gloo"})]


def test_a_failing_child_fails_the_parent():
    t0 = time.monotonic()
    code = tcli.run_children(
        [[sys.executable, "-c", "import sys, time; time.sleep(0.5); "
                                "sys.exit(3)"],
         [sys.executable, "-c", "import time; time.sleep(120)"]],
        dict(os.environ))
    assert code == 3
    assert time.monotonic() - t0 < 60


def test_a_child_ended_by_a_signal_fails_the_parent():
    code = tcli.run_children(
        [[sys.executable, "-c", "import os, signal; "
                                "os.kill(os.getpid(), signal.SIGKILL)"],
         [sys.executable, "-c", "pass"]], dict(os.environ))
    assert code == 128 + 9
    assert tcli.run_children([[sys.executable, "-c", "pass"]] * 2,
                             dict(os.environ)) == 0


def test_sigterm_reaches_every_child(tmp_path):
    """The parent's SIGTERM is passed on: each child records it and exits
    0, so the parent does too."""
    child = ("import signal, sys, time, pathlib\n"
             "def stop(*a):\n"
             "    pathlib.Path(sys.argv[1]).write_text('stopped')\n"
             "    sys.exit(0)\n"
             "signal.signal(signal.SIGTERM, stop)\n"
             "pathlib.Path(sys.argv[1] + '.ready').write_text('')\n"
             "time.sleep(120)\n")
    parent = ("import os, sys\n"
              "from densereg_torch.cli.main import run_children\n"
              f"marks = [{str(tmp_path / 'a')!r}, {str(tmp_path / 'b')!r}]\n"
              f"sys.exit(run_children([[sys.executable, '-c', {child!r}, m] "
              "for m in marks], dict(os.environ)))\n")
    proc = subprocess.Popen([sys.executable, "-c", parent], cwd=ROOT)
    try:
        deadline = time.monotonic() + 60
        while not all((tmp_path / f"{m}.ready").exists() for m in "ab"):
            assert time.monotonic() < deadline and proc.poll() is None
            time.sleep(0.05)
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text() \
        == "stopped"


def test_a_rank_takes_its_visible_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("DENSEREG_VISIBLE_DEVICES", "2,3")
    assert [distributed.local_card(r) for r in range(2)] == [
        torch.device("cuda", 2), torch.device("cuda", 3)]
    monkeypatch.delenv("DENSEREG_VISIBLE_DEVICES")
    assert [distributed.local_card(r) for r in range(4)] == [
        torch.device("cuda", i) for i in range(4)]
    monkeypatch.setenv("DENSEREG_VISIBLE_DEVICES", "7")
    with pytest.raises(RuntimeError, match="no visible card"):
        distributed.local_card(0)


def test_two_devices_train_and_test_as_two_ranks(two_devices, tmp_path,
                                                 monkeypatch, capsys):
    """One ``train`` call and one ``test`` call, each run as two gloo
    ranks; the checkpoint against a one-process ``--no-mesh`` run."""
    monkeypatch.chdir(tmp_path)
    for subset in ("training", "testing"):   # before the processes start
        get_dataset("synthetic", subset, directory="synth")
    train = ["train", "--max_steps", str(STEPS), "--debug_level", "0"]
    assert tcli.main([*train, *_flags(base_dir="mp")]) == 0
    assert tcli.main(["test", *_flags(base_dir="mp")]) == 0
    assert tcli.main([*train, *_flags(base_dir="one"), "--no-mesh"]) == 0
    out = capsys.readouterr().out
    assert out.count("2 visible cpu devices, one process a device") == 2

    run = tmp_path / "mp" / DESC
    names = set(os.listdir(run))
    assert {"training_log.txt", "training_log.p1.txt", "metrics.jsonl",
            "ckpt"} <= names
    assert "training_log.p1.txt" not in os.listdir(tmp_path / "one" / DESC)
    load = lambda side: torch.load(   # noqa: E731
        tmp_path / side / DESC / "ckpt" / f"ckpt_{STEPS}.pt",
        weights_only=False)
    two, one = _flat(load("mp")), _flat(load("one"))
    assert two.keys() == one.keys()
    for k, v in one.items():
        if isinstance(v, torch.Tensor):
            assert (two[k].shape, two[k].dtype) == (v.shape, v.dtype), k
    assert two["step"] == one["step"] == STEPS
    spec = get_dataset("synthetic", "testing", directory="synth")
    lines = (run / f"testing-step{STEPS}-result.txt").read_text() \
        .splitlines()
    assert len(lines) == spec.exact_num
