"""The port's command line (``densereg_torch.cli.main``) against the JAX
package's (``densereg_tpu.cli.main``), on the CPU (``--device cpu``), at
s1/f8/J16 and 32 input on the synthetic dataset:

- the parser: every subcommand has the JAX parser's options with the same
  option strings, defaults, choices, ``nargs``, actions and ``required``,
  except the differences the port declares in ``DIFFERENCES``;
- ``convert --dataset synthetic`` writes the JAX command's shards byte for
  byte;
- ``test --init_params``, both commands on one payload and one set of
  shards in float32: the same result names; every joint's xyz within the
  decode's 2e-4 normalized bound (0.02 mm, ``PARITY.md``) plus 1e-4 mm for
  the ``%.4f`` rounding, except the joints ``tests/test_torch_eval.py``
  names as the JAX decode's own ill-posed cases (a top-k list that reaches
  a non-positive score, where the JAX command's default ``lax.top_k``
  decode orders +0 above -0, fault 3.2; a cancelled mean shift); 17
  error-curve lines each;
- ``train`` -> ``test`` -> ``export --platforms cpu`` -> ``predict``
  through the checkpoint, through ``--artifact`` and with ``--bbx_file``:
  the checkpoint and the artifact write the same result file, and it
  holds ``Predictor.from_checkpoint``'s answers to the file's rounding;
- ``check``: the ``[check]`` stats line equals the JAX command's, and
  ``--num_samples`` PNGs are written;
- ``serve`` in a subprocess, answered by ``serve.Client`` and stopped by
  SIGTERM: exit 0 and the shutdown line;
- ``--device cuda`` where no card is visible exits non-zero with the
  device shim's error; ``--help`` imports no JAX.
"""

import argparse
import glob
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_tpu.cli import main as jcli  # noqa: E402
from densereg_tpu.data.base import get_dataset as jget_dataset  # noqa: E402
from densereg_tpu.train import loop as jloop  # noqa: E402

from densereg_torch import NetConfig, Predictor  # noqa: E402
from densereg_torch.cli import main as tcli  # noqa: E402
from densereg_torch.config import model_desc  # noqa: E402
from densereg_torch.convert import save_converted  # noqa: E402
from densereg_torch.data import get_dataset, synthetic  # noqa: E402
from densereg_torch.eval import read_result_file  # noqa: E402
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.serve import Client  # noqa: E402
from test_torch_eval import _jax_template_state, _joint_causes  # noqa: E402
from test_torch_serving import _hand_frames  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = NetConfig(num_stack=1, num_fea=8, num_joint=16, input_hw=(32, 32),
                compute_dtype="float32")
XYZ_TOL_MM = 0.02 + 1e-4
HEAD_TOL = 1e-4        # per head element (PARITY.md, network row)
RESULT_ROUNDING_MM = 1e-4
SHAPE_FLAGS = ["--num_stack", "1", "--num_fea", "8", "--input_size", "32",
               "--compute_dtype", "float32"]
DESC = model_desc("synthetic", "training", NET, True)


def _by_dest(parser):
    """Per subcommand: its options keyed by ``dest``, each as what the
    parity test compares."""
    subs = next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: {"strings": sorted(a.option_strings),
                            "default": a.default, "choices": a.choices,
                            "nargs": a.nargs, "action": type(a).__name__,
                            "required": a.required, "const": a.const}
                   for a in sp._actions if a.dest != "help"}
            for name, sp in subs.choices.items()}


def test_parser_matches_the_jax_parser():
    ours, theirs = _by_dest(tcli.build_parser()), _by_dest(jcli.build_parser())
    assert ours.keys() == theirs.keys()
    declared = {}
    for subs, option, why in tcli.DIFFERENCES:
        for sub in subs:
            declared.setdefault(sub, {})[option.lstrip("-")] = why
    assert declared.keys() <= ours.keys()
    for sub, mine in ours.items():
        diff = declared.get(sub, {})
        new = mine.keys() - theirs[sub].keys()
        assert new == diff.keys() - theirs[sub].keys(), (sub, new)
        assert not theirs[sub].keys() - mine.keys(), sub
        for dest, want in theirs[sub].items():
            got = dict(mine[dest])
            if dest == "platforms":
                # the declared default; the choices are checked by parsing
                assert got.pop("default") == "cuda,cpu"
                want = {k: v for k, v in want.items() if k != "default"}
            assert got == want, (sub, dest, got, want)
    parse = tcli.build_parser().parse_args
    for value in ("cuda", "cpu", "cuda,cpu"):
        assert parse(["export", "--platforms", value]).platforms == value
    for value in ("tpu", "tpu,cpu", ""):
        with pytest.raises(SystemExit):
            parse(["export", "--platforms", value])
    assert parse(["test"]).device == "cuda"
    assert parse(["check", "--dataset", "nyu", "--device", "cpu"]).device \
        == "cpu"
    assert not hasattr(parse(["convert", "--dataset", "nyu"]), "device")
    # --use_pallas parses and changes nothing: the port's EvalConfig has no
    # such field
    assert parse(["test", "--use_pallas"]).use_pallas
    from densereg_torch.config import EvalConfig

    assert "use_pallas" not in EvalConfig.__dataclass_fields__
    # one process a device on a machine of several (the JAX command line
    # drives them from one process); the options themselves are the same
    assert declared["train"]["mesh"] == declared["test"]["mesh"]
    assert "one process a device" in declared["train"]["mesh"]
    assert ours["train"]["mesh"] == theirs["train"]["mesh"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The synthetic shards converted by each command line, training and
    testing."""
    root = tmp_path_factory.mktemp("cli_data")
    for cli, name in ((jcli, "jax"), (tcli, "torch")):
        for subset in ("training", "testing"):
            assert cli.main(["convert", "--dataset", "synthetic", "--subset",
                             subset, "--data_dir", str(root / name)]) == 0
    return root


def test_convert_writes_the_jax_shards(data):
    theirs = sorted(glob.glob(str(data / "jax" / "*" / "*.npz")))
    ours = sorted(glob.glob(str(data / "torch" / "*" / "*.npz")))
    assert len(ours) == 8
    assert ([os.path.relpath(p, data / "torch") for p in ours]
            == [os.path.relpath(p, data / "jax") for p in theirs])
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


@pytest.fixture(scope="module")
def parity(data, tmp_path_factory):
    """``test --init_params`` of both commands on one payload written by
    the port's ``save_converted`` and on the port's shards."""
    root = tmp_path_factory.mktemp("cli_parity")
    variables = init_variables(NET, seed=21)
    payload = str(root / "params.msgpack")
    save_converted({**variables, "renorm_t": 0.0}, payload)
    args = ["test", "--dataset", "synthetic", "--data_dir",
            str(data / "torch"), "--batch_size", "64", *SHAPE_FLAGS,
            "--init_params", payload]
    with pytest.MonkeyPatch.context() as mp:
        # the JAX test() builds a training state only as the template of
        # the parameter tree (see tests/test_torch_eval.py)
        mp.setattr(jloop, "create_train_state", _jax_template_state)
        assert jcli.main(args + ["--base_dir", str(root / "jax")]) == 0
    assert tcli.main(args + ["--base_dir", str(root / "torch"),
                             "--device", "cpu"]) == 0

    def files(side):
        run = root / side / DESC
        return [sorted(glob.glob(str(run / f"testing-*-{k}")))
                for k in ("result.txt", "result_error.txt")]

    spec = get_dataset("synthetic", "testing", directory=str(data / "torch"))
    jspec = jget_dataset("synthetic", "testing",
                         directory=str(data / "torch"))
    return dict(files=files("torch"), jfiles=files("jax"),
                causes=_joint_causes(spec, jspec, variables, spec.exact_num),
                n=spec.exact_num)


def test_test_command_matches_jax(parity):
    (res, err), (jres, jerr) = parity["files"], parity["jfiles"]
    assert len(res) == len(err) == len(jres) == len(jerr) == 1
    names, xyz = read_result_file(res[0])
    jnames, jxyz = read_result_file(jres[0])
    n = parity["n"]
    assert len(names) == n == 256 and names == jnames
    gap = np.abs(xyz - jxyz).reshape(n, -1, 3).max(-1)
    off = gap > XYZ_TOL_MM
    c = parity["causes"]
    named = c["nonpositive_topk"] | (
        c["cancelled"] & (c["head_err"] <= HEAD_TOL)[:, None])
    bad = [(int(f), int(j), float(gap[f, j]))
           for f, j in np.argwhere(off & ~named)]
    assert not bad, f"(frame, joint, mm) off by more than {XYZ_TOL_MM}: {bad}"
    assert off.mean() < 0.05
    for path in (err[0], jerr[0]):
        with open(path) as f:
            assert len(f.read().splitlines()) == 17


@pytest.fixture(scope="module")
def run(data, tmp_path_factory):
    """``train --max_steps 2`` -> ``test`` -> ``export --platforms cpu``
    -> ``predict`` through the checkpoint, the artifact and a box file,
    all by the port's command line on the CPU."""
    root = tmp_path_factory.mktemp("cli_run")
    common = ["--dataset", "synthetic", "--data_dir", str(data / "torch"),
              "--batch_size", "4", "--sub_batch", "2", *SHAPE_FLAGS,
              "--base_dir", str(root / "cache"), "--device", "cpu"]
    assert tcli.main(["train", *common, "--max_steps", "2", "--keep_best",
                      "--debug_level", "0"]) == 0
    assert tcli.main(["test", *common, "--use_best"]) == 0
    art = str(root / "m.drexpt")
    assert tcli.main(["export", *common, "--platforms", "cpu",
                      "--out", art]) == 0
    from PIL import Image

    frames, bbxs = _hand_frames(np.random.default_rng(5), 5)
    img_dir = root / "imgs"
    img_dir.mkdir()
    for i, frame in enumerate(frames):
        Image.fromarray(frame.astype(np.uint16)).save(
            str(img_dir / f"frame_{i}.png"), format="PNG")
    box_file = str(root / "boxes.txt")
    np.savetxt(box_file, bbxs)
    outs = {}
    for name, extra in (("ckpt", []), ("artifact", ["--artifact", art]),
                        ("boxes", ["--bbx_file", box_file])):
        outs[name] = str(root / f"{name}.txt")
        assert tcli.main(["predict", *common, "--images", str(img_dir),
                          "--out", outs[name], *extra]) == 0
    return dict(root=root, common=common, frames=frames, bbxs=bbxs,
                outs=outs, art=art)


def test_train_test_export_predict(run):
    train_dir = run["root"] / "cache" / DESC
    have = set(os.listdir(train_dir))
    assert {"ckpt", "ckpt_best", "best.json", "metrics.jsonl",
            "training_log.txt"} <= have
    assert "ckpt_2.pt" in os.listdir(train_dir / "ckpt")
    (res,) = glob.glob(str(train_dir / "testing-*-result.txt"))
    assert len(read_result_file(res)[0]) == 256

    with open(run["outs"]["ckpt"]) as f:
        ckpt_lines = f.read()
    with open(run["outs"]["artifact"]) as f:
        assert f.read() == ckpt_lines
    names, xyz = read_result_file(run["outs"]["ckpt"])
    assert names == [f"frame_{i}.png" for i in range(5)]
    pred = Predictor.from_checkpoint(str(train_dir), NET,
                                     synthetic.CFG,
                                     max_batch=4, device="cpu")
    h, w = run["frames"].shape[1:]
    full = np.tile(np.asarray([0, 0, h, w, 500.0], np.float32), (5, 1))
    np.testing.assert_allclose(xyz, pred(run["frames"], full),
                               atol=RESULT_ROUNDING_MM, rtol=0)
    _, boxed = read_result_file(run["outs"]["boxes"])
    np.testing.assert_allclose(boxed, pred(run["frames"], run["bbxs"]),
                               atol=RESULT_ROUNDING_MM, rtol=0)
    assert np.abs(boxed - xyz).max() > 1.0      # the boxes were read


def test_check_prints_the_jax_line(data, tmp_path, capsys):
    args = ["check", "--dataset", "synthetic", "--data_dir",
            str(data / "torch"), "--num_samples", "3", "--input_size", "32"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert tcli.main(args + ["--out", str(tmp_path / "torch"),
                             "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    assert ours[0].startswith("[check] synthetic/training: batch dm(3, 32")
    assert ours[0] == theirs[0]
    assert ([line.rsplit("name=", 1)[1] for line in ours[1:]]
            == [line.rsplit("name=", 1)[1] for line in theirs[1:]])
    pngs = sorted(os.listdir(tmp_path / "torch"))
    assert pngs == [f"check_synthetic_{i}.png" for i in range(3)]
    for p in pngs:
        with open(tmp_path / "torch" / p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_serve_answers_and_stops_on_sigterm(run):
    sock_dir = tempfile.mkdtemp(prefix="drcli")
    sock = os.path.join(sock_dir, "s.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "densereg_torch.cli.main", "serve",
         *run["common"], "--socket", sock, "--stats_interval", "0.2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        lines = []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("[serve] listening on"):
                break
        assert lines and lines[-1].startswith("[serve] listening"), lines
        frames, bbxs = run["frames"], run["bbxs"]
        with Client(sock) as client:
            got = client.predict_batch(frames, bbxs)
        pred = Predictor.from_checkpoint(
            str(run["root"] / "cache" / DESC), NET,
            synthetic.CFG, max_batch=4,
            device="cpu")
        np.testing.assert_allclose(got, pred(frames, bbxs), atol=1e-3,
                                   rtol=0)
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(lines) + rest
    assert proc.returncode == 0, out
    assert "[serve] compiled buckets=[4] frame_hw=(240, 320)" in out
    assert "[serve] shutdown: 5 responses in" in out and "(0 errors)" in out


def test_device_cuda_without_a_card_fails():
    env = dict(os.environ, DENSEREG_VISIBLE_DEVICES="99")
    out = subprocess.run(
        [sys.executable, "-m", "densereg_torch.cli.main", "test",
         "--dataset", "synthetic"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no visible cuda device" in out.stderr


def test_help_imports_no_jax():
    code = (
        "import runpy, sys\n"
        "for argv in (['--help'], ['train', '--help'], ['serve', '--help']):\n"
        "    sys.argv = ['densereg_torch.cli.main'] + argv\n"
        "    try:\n"
        "        runpy.run_module('densereg_torch.cli.main',"
        " run_name='__main__')\n"
        "    except SystemExit as exc:\n"
        "        assert exc.code == 0, exc.code\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'densereg_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage: densereg_torch" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"
