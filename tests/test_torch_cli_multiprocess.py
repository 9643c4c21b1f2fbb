"""The port's command line in two processes joined in a gloo group through
``--coordinator_address`` (``--device cpu``), as
``tests/test_cli_multiprocess.py`` runs the JAX command line: the SAME
``train`` command in both processes (only ``--process_id`` differs), then
the same ``test`` command.

Rank 0 alone writes the run's files (the checkpoints, ``metrics.jsonl``,
the event file, ``keep_best``); rank 1 keeps its own text log. The
checkpoint is held against a one-process run of the same command: the
same tree of parameters, optimizer moments and statistics (names, shapes,
dtypes), the same step, renorm clock and optimizer count, every value
finite; both ranks log the same global loss. The values themselves
differ: each process reads its share of the shards and draws its
augmentation and dropout from its own seed, in both packages, so the two
runs train on different frames (the step on one global batch is held to
the one-process step in ``tests/test_torch_parallel.py``). The
two-process ``test`` writes one merged result file that equals a
one-process ``test`` of the same checkpoint line for line.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_torch.cli import main as tcli  # noqa: E402
from densereg_torch.data import get_dataset  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPROC = 2
STEPS = 3
DESC = "synthetic_training_s1_f8_in32_daug_um_v1"


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flags(data_dir, base_dir):
    return ["--dataset", "synthetic", "--data_dir", data_dir,
            "--input_size", "32", "--batch_size", "8", "--sub_batch", "1",
            "--num_stack", "1", "--num_fea", "8",
            "--compute_dtype", "float32", "--base_dir", base_dir,
            "--device", "cpu"]


def _run_group(cmd):
    """The same command in ``NPROC`` processes of one gloo group; returns
    each process's output."""
    coord = f"127.0.0.1:{_free_port()}"
    # each process takes its share of this process's threads (as torchrun
    # sets OMP_NUM_THREADS): idle OpenMP threads of two processes spinning
    # on the same cores make a step some 15x slower
    env = dict(os.environ,
               OMP_NUM_THREADS=str(max(1, torch.get_num_threads() // NPROC)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "densereg_torch.cli.main", *cmd,
         "--coordinator_address", coord, "--num_processes", str(NPROC),
         "--process_id", str(r)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(NPROC)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_climp")
    data = str(root / "synth")
    for subset in ("training", "testing"):   # before the processes start
        get_dataset("synthetic", subset, directory=data)
    train = ["train", "--max_steps", str(STEPS), "--keep_best",
             "--debug_level", "0"]
    outs = _run_group(train + _flags(data, str(root / "mp")))
    _run_group(["test"] + _flags(data, str(root / "mp")))
    assert tcli.main(train + _flags(data, str(root / "one"))) == 0
    assert tcli.main(["test"] + _flags(data, str(root / "mp"))) == 0
    return root, outs


def test_rank_zero_writes_the_files(runs):
    root, outs = runs
    run = root / "mp" / DESC
    names = set(os.listdir(run))
    assert {"training_log.txt", "training_log.p1.txt", "metrics.jsonl",
            "ckpt", "ckpt_best", "best.json", "summary"} <= names
    assert f"ckpt_{STEPS}.pt" in os.listdir(run / "ckpt")
    with open(run / "metrics.jsonl") as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == sorted(set(steps)) == [0]
    events = os.listdir(run / "summary")
    assert len([e for e in events if "tfevents" in e]) == 1, events
    assert "new best validation error" in outs[0]
    assert "new best validation error" not in outs[1]


def test_ranks_log_the_same_global_loss(runs):
    """Each rank's text log holds the loss of the global batch (summed over
    the ranks before the log), so the two logs agree to the digit."""
    import re

    root, _ = runs
    run = root / "mp" / DESC
    losses = [re.findall(r"step (\d+)/\d+, loss = ([\d.]+)",
                         (run / name).read_text())
              for name in ("training_log.txt", "training_log.p1.txt")]
    assert losses[0] and losses[0] == losses[1]


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def test_checkpoint_matches_a_one_process_run(runs):
    root, _ = runs
    load = lambda side: torch.load(   # noqa: E731
        root / side / DESC / "ckpt" / f"ckpt_{STEPS}.pt", weights_only=False)
    two, one = _flat(load("mp")), _flat(load("one"))
    assert two.keys() == one.keys()
    tensors = 0
    for k, v in one.items():
        w = two[k]
        if isinstance(v, torch.Tensor):
            tensors += 1
            assert (w.shape, w.dtype) == (v.shape, v.dtype), k
            if w.is_floating_point():
                assert torch.isfinite(w).all(), k
        elif not isinstance(v, (bytes, bytearray)) and "generator" not in k:
            assert w == v, (k, w, v)     # the step, the clocks, the config
    assert tensors > 20
    assert two["step"] == STEPS
    assert torch.equal(two["renorm_t"], one["renorm_t"])
    params = [k for k in one if k.startswith("net/") and "kernel" in k]
    assert params and any(not torch.equal(two[k], one[k]) for k in params)


def test_two_process_test_merges_to_a_one_process_test(runs):
    root, _ = runs
    run = root / "mp" / DESC
    spec = get_dataset("synthetic", "testing",
                       directory=str(root / "synth"))
    for suffix in ("result.txt", "result_error.txt"):
        merged = (run / f"testing-step{STEPS}-{suffix}").read_text()
        (single,) = [p for p in glob.glob(str(run / f"testing-*-{suffix}"))
                     if "-step" not in os.path.basename(p)]
        with open(single) as f:
            assert merged.splitlines() == f.read().splitlines(), suffix
    lines = (run / f"testing-step{STEPS}-result.txt").read_text().splitlines()
    assert len(lines) == spec.exact_num
    values = np.asarray([line.split("\t")[1:] for line in lines], float)
    assert np.isfinite(values).all()
