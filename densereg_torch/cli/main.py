"""Command line of the port, the counterpart of ``densereg_tpu/cli/main.py``
function by function:

    python -m densereg_torch.cli.main train --dataset icvl --epoch 80 ...
    python -m densereg_torch.cli.main test  --dataset msra --pid 3
    python -m densereg_torch.cli.main convert --dataset nyu --subset training
    python -m densereg_torch.cli.main check --dataset synthetic --device cpu
    python -m densereg_torch.cli.main export --platforms cuda
    python -m densereg_torch.cli.main predict --images f/ --artifact m.drexpt
    python -m densereg_torch.cli.main serve --socket /tmp/densereg.sock

Every subcommand has the JAX command line's options, with the same option
strings, defaults, choices and ``nargs``, and runs through the port's own
entry points, on the card unless given ``--device cpu``. The differences,
all of them (``DIFFERENCES`` below, which ``tests/test_torch_cli.py``
reads):

==============  ===============================  ==========================
option          subcommands                      difference
==============  ===============================  ==========================
--device        train, test, check, export,      new, ``cuda`` (default) or
                predict, serve                   ``cpu``: the device the
                                                 entry points run on (the
                                                 JAX package picks its
                                                 platform through
                                                 ``JAX_PLATFORMS``)
--platforms     export                           default ``cuda,cpu``
                                                 (JAX: ``tpu,cpu``); takes
                                                 only ``cuda`` and ``cpu``
--use_pallas    test                             accepted and ignored: on a
                                                 CUDA tensor the decode is
                                                 always the fused kernel,
                                                 on the CPU its plain
                                                 version
--mesh          train, test                      on more than one visible
                                                 device: one process a
                                                 device in a local group,
                                                 each reading its share of
                                                 the shards and seeding
                                                 with seed + 104729·rank
                                                 (the JAX package drives
                                                 every local chip from one
                                                 process)
==============  ===============================  ==========================

Help texts name ``torch.profiler`` and ``torch.export`` where the JAX ones
name ``jax.profiler`` and ``jax.export``. Under ``--coordinator_address``
(or ``DENSEREG_NUM_PROCESSES``, ``parallel.initialize_distributed``) the
processes join a ``torch.distributed`` group (NCCL with ``--device cuda``,
gloo with ``--device cpu``) before anything touches the card; rank ``i``
takes the ``i``-th card of ``DENSEREG_VISIBLE_DEVICES``
(``parallel.distributed.local_card``). Without either, ``train`` and
``test`` with ``--mesh`` (the default) on a machine of more than one
visible device start that group themselves: one child a device, each
running this same command line with the group's flags added
(:func:`launch_local_group`). ``check`` and ``--debug_level`` >= 1 draw
with matplotlib.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from densereg_torch.config import EvalConfig, NetConfig, TrainConfig

DATASETS = ["icvl", "nyu", "msra", "bighand", "synthetic"]
PLATFORMS = ("cuda", "cpu")

# (subcommands, option, what differs from densereg_tpu.cli.main)
DIFFERENCES = (
    (("train", "test", "check", "export", "predict", "serve"), "--device",
     "new: the device the entry points run on, cuda (default) or cpu"),
    (("export",), "--platforms",
     "default cuda,cpu (JAX: tpu,cpu); takes only cuda and cpu"),
    (("test",), "--use_pallas",
     "accepted and ignored: the fused decode kernel on the card, its plain "
     "version on the CPU"),
    (("train", "test"), "--mesh",
     "on more than one visible device: one process a device in a local "
     "group, each reading its share of the shards and seeding with seed + "
     "104729*rank (JAX: every local chip from one process)"),
)


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=list(PLATFORMS),
                   help="run on the card (default) or on the CPU")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dataset", default="nyu", choices=DATASETS)
    p.add_argument("--data_dir", default=None,
                   help="dataset root (defaults to the reference layout)")
    p.add_argument("--pid", type=int, default=0, help="msra subject id")
    p.add_argument("--batch_size", type=int, default=40)
    p.add_argument("--sub_batch", type=int, default=5)
    p.add_argument("--debug_level", type=int, default=1,
                   help="gates validation image summaries (reference flag; "
                        ">= 1 needs matplotlib)")
    p.add_argument("--num_stack", type=int, default=2)
    p.add_argument("--num_fea", type=int, default=128)
    p.add_argument("--kernel_size", type=int, default=3)
    p.add_argument("--net_module", default="um_v1",
                   choices=["um_v1", "um_v1_lite", "um_v1_deconv"])
    p.add_argument("--input_size", type=int, default=128,
                   choices=[32, 64, 128, 256, 512],
                   help="square crop size; sets the hourglass depth "
                        "(128->4, 256->5, 512->6)")
    p.add_argument("--epoch", type=int, default=80)
    p.add_argument("--epochs_per_decay", type=int, default=None,
                   help="override the per-dataset LR decay horizon")
    p.add_argument("--is_aug", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--compute_dtype", default="bfloat16",
                   choices=["float32", "bfloat16"])
    p.add_argument("--base_dir", default="./exp/train_cache/")
    p.add_argument("--mesh", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="train and test: data parallel, one process a "
                        "visible card (the command starts them where no "
                        "group is given)")
    # multi-process (torch.distributed): run the SAME command in every
    # process with its own --process_id; rank 0 writes the files
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (joins a torch.distributed "
                        "group)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    _add_device(p)


def _specs(args, subset_train="training", subset_test="testing"):
    from densereg_torch.data import get_dataset

    kwargs = {}
    if args.data_dir:
        kwargs["directory"] = args.data_dir
    if args.dataset == "msra":
        kwargs["pid"] = args.pid
    train_spec = get_dataset(args.dataset, subset_train, **kwargs)
    test_spec = get_dataset(args.dataset, subset_test, **kwargs)
    return train_spec, test_spec


def _configs(args, jnt_num):
    epochs_per_decay = args.epochs_per_decay or {
        "nyu": 10, "msra": 20}.get(args.dataset, 10)
    net = NetConfig(num_stack=args.num_stack, num_fea=args.num_fea,
                    kernel_size=args.kernel_size, num_joint=jnt_num,
                    input_hw=(args.input_size, args.input_size),
                    compute_dtype=args.compute_dtype,
                    net_module=args.net_module)
    tcfg = TrainConfig(batch_size=args.batch_size, sub_batch=args.sub_batch,
                       epochs=args.epoch, augment=args.is_aug,
                       epochs_per_decay=epochs_per_decay,
                       base_dir=args.base_dir)
    return net, tcfg


def _mesh(args):
    """The group's mesh, this rank's device (``parallel.make_mesh``), when
    the process is one of a group of several and ``--mesh`` is on; else
    None, one device. (Without a group, more than one visible device makes
    ``main`` start a group first, :func:`launch_local_group`.)"""
    import torch.distributed as dist

    if not (args.mesh and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    from densereg_torch.parallel import make_mesh

    return make_mesh(devices=None if args.device == "cuda"
                     else [args.device])


def local_group_size(args) -> int:
    """How many processes ``main`` starts for ``args``: one a visible
    device for ``train`` and ``test`` with ``--mesh`` where more than one
    device is visible and no group is asked for (no
    ``--coordinator_address``, no ``DENSEREG_NUM_PROCESSES``); else 0, the
    command runs in this process."""
    if (args.cmd not in ("train", "test") or not args.mesh
            or args.coordinator_address is not None
            or "DENSEREG_NUM_PROCESSES" in os.environ):
        return 0
    from densereg_torch.utils.device import visible_devices

    n = len(visible_devices(args.device))
    return n if n > 1 else 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_group(argv, n: int, device: str) -> int:
    """Run ``argv`` (a ``train`` or ``test`` command line) in ``n`` child
    processes of one local group, rank ``i`` on the ``i``-th visible device:
    each child is ``python -m densereg_torch.cli.main argv
    --coordinator_address 127.0.0.1:<free port> --num_processes n
    --process_id i``. Where ``OMP_NUM_THREADS`` is unset, each child gets
    its share of the cores (idle OpenMP threads of several processes on the
    same cores made a gloo step some 15x slower). Returns
    :func:`run_children`'s exit code."""
    coordinator = f"127.0.0.1:{_free_port()}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    print(f"[densereg_torch] {argv[0]}: {n} visible {device} devices, one "
          f"process a device (a local group at {coordinator})", flush=True)
    return run_children(
        [[sys.executable, "-m", "densereg_torch.cli.main", *argv,
          "--coordinator_address", coordinator, "--num_processes", str(n),
          "--process_id", str(i)] for i in range(n)], env)


def run_children(commands, env, grace_s: float = 30.0) -> int:
    """Start one child a command and wait for all of them. SIGTERM sent to
    this process goes on to every child (a rank that stops alone leaves the
    others waiting in the next collective). When a child fails, the others
    are sent SIGTERM, and killed after ``grace_s`` seconds. Returns the
    first nonzero exit code (128 + the signal's number for a child ended
    by a signal), 0 when every child exits 0."""
    procs = [subprocess.Popen(c, env=env) for c in commands]

    def stop(signum=signal.SIGTERM, _frame=None):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    main_thread = threading.current_thread() is threading.main_thread()
    previous = signal.signal(signal.SIGTERM, stop) if main_thread else None
    code, deadline = 0, None
    try:
        while any(p.poll() is None for p in procs):
            if code == 0:
                failed = [p.returncode for p in procs
                          if p.returncode not in (None, 0)]
                if failed:
                    code = failed[0]
                    stop()
                    deadline = time.monotonic() + grace_s
            elif time.monotonic() > deadline:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            time.sleep(0.05)
    finally:   # an interrupt of this process: stop them too
        stop()
        for p in procs:
            try:
                p.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if main_thread:
            signal.signal(signal.SIGTERM, previous)
    if code == 0:
        code = next((p.returncode for p in procs if p.returncode), 0)
    return 128 - code if code < 0 else code


def cmd_train(args) -> int:
    from densereg_torch.train.loop import train

    train_spec, val_spec = _specs(args)
    net, tcfg = _configs(args, train_spec.jnt_num)
    tcfg = dataclasses.replace(tcfg, profile_dir=args.profile_dir,
                               ema_decay=args.ema_decay,
                               loss_type=args.loss_type,
                               host_preprocess=args.host_preprocess,
                               wire_dtype=args.wire_dtype,
                               keep_best=args.keep_best,
                               num_workers=args.num_workers)
    restore = "auto" if args.resume else args.restore_step
    train(train_spec, net, tcfg, val_spec=val_spec,
          restore_step=restore, init_params=args.init_params,
          mesh=_mesh(args),
          max_steps=args.max_steps, net_name=args.net_module,
          debug_level=args.debug_level, device=args.device)
    return 0


def cmd_test(args) -> int:
    from densereg_torch.train.loop import test

    train_spec, test_spec = _specs(args)
    net, tcfg = _configs(args, test_spec.jnt_num)
    if args.ema_decay is not None:
        tcfg = dataclasses.replace(tcfg, ema_decay=args.ema_decay)
    ecfg = EvalConfig(batch_size=args.batch_size,
                      host_preprocess=args.host_preprocess,
                      wire_dtype=args.wire_dtype)
    test(test_spec, net, tcfg, ecfg, selected_step=args.selected_step,
         mesh=_mesh(args), train_spec=train_spec, net_name=args.net_module,
         use_ema=args.use_ema, use_best=args.use_best,
         init_params=args.init_params, device=args.device)
    return 0


def cmd_convert(args) -> int:
    if args.dataset == "icvl":
        from densereg_torch.data import icvl
        icvl.convert(args.data_dir or icvl.DEFAULT_DIR, args.subset,
                     args.num_threads)
    elif args.dataset == "nyu":
        from densereg_torch.data import nyu
        nyu.convert(args.data_dir or nyu.DEFAULT_DIR, args.subset,
                    args.num_threads)
    elif args.dataset == "msra":
        from densereg_torch.data import msra
        for pid in ([args.pid] if args.pid >= 0 else range(msra.NUM_PIDS)):
            msra.convert(args.data_dir or msra.DEFAULT_DIR, pid,
                         args.num_threads)
    elif args.dataset == "bighand":
        from densereg_torch.data import bighand
        bighand.convert(args.data_dir or bighand.DEFAULT_DIR, args.subset,
                        args.num_threads)
    elif args.dataset == "synthetic":
        from densereg_torch.data import synthetic
        synthetic.ensure_shards(args.data_dir or synthetic.DEFAULT_DIR,
                                args.subset)
    else:
        raise SystemExit(f"no converter for {args.dataset}")
    return 0


def cmd_check(args) -> int:
    """Visual smoke test: pull a batch through the real pipeline (shards ->
    crop and normalization on ``--device``) and dump skeleton-annotated
    depth maps and stats (needs matplotlib)."""
    import os

    import numpy as np
    import torch

    from densereg_torch import geometry
    from densereg_torch.data import TestPipeline, get_dataset
    from densereg_torch.eval.visualization import figure_joint_skeleton

    kwargs = {}
    if args.data_dir:
        kwargs["directory"] = args.data_dir
    if args.dataset == "msra":
        kwargs["pid"] = args.pid
    spec = get_dataset(args.dataset, args.subset, **kwargs)
    pipe = TestPipeline(spec, batch_size=args.num_samples,
                        input_hw=(args.input_size, args.input_size),
                        device=args.device)
    batch = next(iter(pipe))
    dm, pose, cfgs, com = (batch[k].cpu().numpy()
                           for k in ("dm", "pose", "cfg", "com"))
    valid = dm[dm > 0]
    print(f"[check] {spec.name}/{spec.subset}: batch dm{dm.shape} "
          f"pose{pose.shape}; depth mm [{valid.min():.0f}, {valid.max():.0f}]"
          f" mean {valid.mean():.0f}; com z [{com[:, 2].min():.0f},"
          f" {com[:, 2].max():.0f}]")
    os.makedirs(args.out, exist_ok=True)
    for i in range(dm.shape[0]):
        uvd = geometry.xyz2uvd(torch.from_numpy(pose[i]),
                               torch.from_numpy(cfgs[i])).numpy()
        fig = figure_joint_skeleton(dm[i, ..., 0], uvd.reshape(-1, 3),
                                    spec.name)
        path = os.path.join(args.out, f"check_{spec.name}_{i}.png")
        fig.savefig(path)
        print(f"[check] wrote {path}  name={batch['name'][i]}")
    return 0


def cmd_export(args) -> int:
    """Bake a trained checkpoint into a standalone ``torch.export`` serving
    artifact (weights + crop/forward/decode; see densereg_torch.export)."""
    import os

    from densereg_torch.export import export_predictor

    pred, desc = _checkpoint_predictor(args)
    out = args.out or f"{desc}.drexpt"
    export_predictor(pred, out, platforms=tuple(args.platforms.split(",")))
    print(f"[export] wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB, "
          f"max_batch={args.batch_size}, "
          f"buckets={list(pred.batch_buckets)}, "
          f"platforms={args.platforms})")
    return 0


def _checkpoint_predictor(args):
    """The live predictor of the checkpoint that the common flags select,
    on ``--device``, and the run's directory name."""
    import os

    from densereg_torch.config import model_desc
    from densereg_torch.serving import Predictor

    train_spec, test_spec = _specs(args)
    net, _ = _configs(args, test_spec.jnt_num)
    desc = model_desc(train_spec.name, train_spec.subset, net,
                      args.is_aug, args.net_module)
    buckets = getattr(args, "batch_buckets", None)
    if buckets:
        buckets = tuple(int(v) for v in str(buckets).split(",") if v)
    return Predictor.from_checkpoint(
        os.path.join(args.base_dir, desc), net, test_spec.cfg,
        step=args.selected_step, max_batch=args.batch_size,
        quantize=args.quantize, use_ema=args.use_ema,
        use_best=args.use_best, batch_buckets=buckets or None,
        device=args.device), desc


def _load_predictor(args):
    """Shared predictor loader for the serving surfaces (predict/serve):
    a ``torch.export`` artifact if ``--artifact`` is given, otherwise the
    checkpoint selected by the common flags, on ``--device``."""
    if args.artifact:
        from densereg_torch.export import load_exported
        return load_exported(args.artifact, device=args.device)
    return _checkpoint_predictor(args)[0]


def cmd_serve(args) -> int:
    """Run the persistent micro-batching inference daemon: load once, run
    every serving program once, then stream length-framed depth-frame
    requests over a Unix socket (or TCP with ``--socket host:port``). See
    densereg_torch/serve.py for the wire protocol."""
    from densereg_torch.serve import Server

    pred = _load_predictor(args)

    # warm up every (batch bucket, dtype) program, the kernels' build
    # included, BEFORE accepting traffic, so that the first client never
    # pays for it inside its request latency
    t0 = time.time()
    pred.warmup(with_u16=pred.accepts_u16)
    print(f"[serve] compiled buckets={list(pred.batch_buckets)} "
          f"frame_hw={pred.frame_hw} in {time.time() - t0:.1f}s")

    server = Server(pred, args.socket, window_ms=args.window_ms,
                    max_queue=args.max_queue)
    stop = threading.Event()

    def _sig(_s, _f):
        stop.set()

    signal.signal(signal.SIGTERM, _sig)
    signal.signal(signal.SIGINT, _sig)
    print(f"[serve] listening on {server.address}", flush=True)
    try:
        last = 0
        while not stop.wait(timeout=args.stats_interval):
            st = server.stats()
            if st["responses"] != last:  # only log when traffic moved
                last = st["responses"]
                print(f"[serve] reqs={st['requests']} "
                      f"batches={st['batches']} "
                      f"mean_batch={st['mean_batch']:.1f} "
                      f"p50={st['p50_ms']}ms p99={st['p99_ms']}ms",
                      flush=True)
    finally:
        st = server.stats()
        server.shutdown()
        print(f"[serve] shutdown: {st['responses']} responses in "
              f"{st['uptime_s']}s ({st['errors']} errors)", flush=True)
    return 0


def cmd_predict(args) -> int:
    """Serve raw depth images straight from disk: a directory (or glob) of
    16-bit depth PNGs in, a reference-format result txt out. Runs either a
    ``torch.export`` artifact (``--artifact``, loadable without model code)
    or a training checkpoint through
    :class:`densereg_torch.serving.Predictor`."""
    import glob as globmod
    import os

    import numpy as np

    from densereg_torch.data.png16 import read_depth_png
    from densereg_torch.eval.writer import ResultWriter

    pattern = args.images
    if os.path.isdir(pattern):
        pattern = os.path.join(pattern, "*.png")
    paths = sorted(globmod.glob(pattern))
    if not paths:
        raise SystemExit(f"no images match {args.images}")
    frames = np.stack([read_depth_png(p, nyu_packed=args.nyu_png)
                       for p in paths])
    h, w = frames.shape[1:3]

    if args.bbx_file:
        # one "top left bottom right depth_threshold" line per image, in
        # sorted-path order (the nyu_bbx.pkl contract as plain text)
        bbxs = np.loadtxt(args.bbx_file, dtype=np.float32).reshape(-1, 5)
        if bbxs.shape[0] != len(paths):
            raise SystemExit(f"{args.bbx_file}: {bbxs.shape[0]} boxes for "
                             f"{len(paths)} images")
    else:  # full-frame box; the crop culls depth >= depth_threshold (mm)
        bbxs = np.tile(np.asarray(
            [0, 0, h, w, args.depth_threshold], np.float32), (len(paths), 1))

    pred = _load_predictor(args)

    xyz = pred(frames, bbxs)
    with ResultWriter(args.out) as wtr:
        wtr.write_batch([os.path.basename(p) for p in paths], xyz)
    print(f"[predict] {len(paths)} frames -> {args.out}")
    return 0


def _platforms(value: str) -> str:
    """``--platforms``: a comma-separated list of ``cuda`` and ``cpu``."""
    bad = [v for v in value.split(",") if v not in PLATFORMS]
    if bad or not value:
        raise argparse.ArgumentTypeError(
            f"platforms must be a comma-separated list of {PLATFORMS}, "
            f"got {value!r}")
    return value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="densereg_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pt = sub.add_parser("train", help="train a model")
    _add_common(pt)
    pt.add_argument("--restore_step", type=int, default=None)
    pt.add_argument("--resume", action="store_true",
                    help="auto-resume from the latest checkpoint")
    pt.add_argument("--max_steps", type=int, default=None)
    pt.add_argument("--profile_dir", default=None,
                    help="capture a torch.profiler trace of a few steps")
    pt.add_argument("--ema_decay", type=float, default=None)
    pt.add_argument("--loss_type", choices=["l2", "l1"], default="l2",
                    help="data-term loss on the map heads: l2 = the "
                         "reference's tf.nn.l2_loss; l1 = the slim "
                         "vocabulary's l1_loss")
    pt.add_argument("--host_preprocess", action="store_true",
                    help="crop/center-of-mass on the host CPU and transfer "
                         "the cropped float32 batch")
    pt.add_argument("--num_workers", type=int, default=1,
                    help="input-pipeline producer threads (shard reads and, "
                         "with --host_preprocess, the CPU crop)")
    pt.add_argument("--wire_dtype", choices=["float32", "uint16"],
                    default="float32",
                    help="with --host_preprocess: wire encoding of the "
                         "cropped batch (uint16 = per-batch fixed point, "
                         "half the bytes, <=0.005 mm quantization)")
    pt.add_argument("--keep_best", action="store_true",
                    help="track the best-validation-error checkpoint in a "
                         "retention-protected ckpt_best/ slot (evaluate it "
                         "with `test --use_best`)")
    pt.add_argument("--init_params", default=None,
                    help="warm-start a fresh run from a converted-"
                         "checkpoint msgpack (python -m "
                         "densereg_torch.convert, or the JAX package's) — "
                         "finetune from the released pretrained models; "
                         "ignored when resuming")
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("test", help="evaluate a checkpoint on the test split")
    _add_common(pe)
    pe.add_argument("--selected_step", type=int, default=-1,
                    help="-1 = latest checkpoint")
    pe.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="accepted so that existing scripts parse, and "
                         "ignored: on the card the decode always runs the "
                         "fused CUDA kernel, on the CPU its plain version")
    pe.add_argument("--use_ema", action="store_true",
                    help="evaluate EMA weights (run must be trained with "
                         "--ema_decay)")
    pe.add_argument("--use_best", action="store_true",
                    help="evaluate the best-validation checkpoint (run "
                         "must be trained with --keep_best)")
    pe.add_argument("--host_preprocess", action="store_true",
                    help="crop on the host CPU; transfer the cropped "
                         "float32 batch")
    pe.add_argument("--wire_dtype", choices=["float32", "uint16"],
                    default="float32",
                    help="with --host_preprocess: wire encoding of the "
                         "cropped batch (uint16 = per-batch fixed point, "
                         "half the bytes, <=0.005 mm quantization)")
    pe.add_argument("--ema_decay", type=float, default=None,
                    help="the training run's (kept for the JAX command "
                         "line; the port's checkpoint carries its EMA)")
    pe.add_argument("--init_params", default=None,
                    help="evaluate a converted-checkpoint msgpack directly "
                         "— the reference's 'step -1 = downloaded "
                         "pretrained' workflow; skips the checkpoint "
                         "restore")
    pe.set_defaults(fn=cmd_test)

    pc = sub.add_parser("convert", help="convert source datasets to shards")
    pc.add_argument("--dataset", required=True, choices=DATASETS)
    pc.add_argument("--subset", default="training")
    pc.add_argument("--data_dir", default=None)
    pc.add_argument("--pid", type=int, default=-1,
                    help="msra subject (-1 = all)")
    pc.add_argument("--num_threads", type=int, default=8)
    pc.set_defaults(fn=cmd_convert)

    pk = sub.add_parser("check", help="visual smoke test of a converted "
                                      "dataset (annotated depth maps)")
    pk.add_argument("--dataset", required=True, choices=DATASETS)
    pk.add_argument("--subset", default="training")
    pk.add_argument("--data_dir", default=None)
    pk.add_argument("--pid", type=int, default=0)
    pk.add_argument("--num_samples", type=int, default=4)
    pk.add_argument("--input_size", type=int, default=128)
    pk.add_argument("--out", default="./check_out")
    _add_device(pk)
    pk.set_defaults(fn=cmd_check)

    px = sub.add_parser("export", help="bake a checkpoint into a standalone "
                                       "torch.export serving artifact")
    _add_common(px)
    px.add_argument("--selected_step", type=int, default=-1,
                    help="-1 = latest checkpoint")
    px.add_argument("--quantize", action="store_true",
                    help="export the int8-weight serving graph")
    px.add_argument("--use_ema", action="store_true",
                    help="export the EMA weights (run trained with "
                         "--ema_decay)")
    px.add_argument("--use_best", action="store_true",
                    help="export the best-validation checkpoint (run "
                         "trained with --keep_best)")
    px.add_argument("--ema_decay", type=float, default=None)
    px.add_argument("--platforms", default="cuda,cpu", type=_platforms,
                    help="comma-separated targets: cuda, cpu (cuda needs "
                         "a card)")
    px.add_argument("--batch_buckets", default=None,
                    help="comma-separated dispatch-size ladder to embed "
                         "(e.g. 1,8,64): the artifact carries one program "
                         "per (bucket, dtype) so exported-artifact servers "
                         "keep the lone-request latency win; each program "
                         "adds roughly one weights-worth of bytes")
    px.add_argument("--out", default=None,
                    help="output path (default <model-desc>.drexpt)")
    px.set_defaults(fn=cmd_export)

    pp = sub.add_parser("predict", help="predict joints for raw depth "
                                        "images (PNG dir/glob -> result txt)")
    _add_common(pp)
    pp.add_argument("--images", required=True,
                    help="directory or glob of 16-bit depth PNGs")
    pp.add_argument("--artifact", default=None,
                    help="torch.export artifact (.drexpt); otherwise the "
                         "checkpoint selected by the common flags is used")
    pp.add_argument("--out", default="predict-result.txt")
    pp.add_argument("--bbx_file", default=None,
                    help="optional text file: one 'top left bottom right "
                         "depth_threshold' line per image (sorted order); "
                         "default is the full frame")
    pp.add_argument("--depth_threshold", type=float, default=500.0,
                    help="absolute background-cull depth in mm (pixels "
                         "deeper are zeroed, like ICVL's fixed 500 mm cull) "
                         "for the default full-frame box")
    pp.add_argument("--nyu_png", action="store_true",
                    help="depth packed as G<<8|B (the NYU PNG layout)")
    pp.add_argument("--selected_step", type=int, default=-1)
    pp.add_argument("--quantize", action="store_true",
                    help="serve the int8-weight graph")
    pp.add_argument("--use_ema", action="store_true")
    pp.add_argument("--use_best", action="store_true")
    pp.add_argument("--ema_decay", type=float, default=None)
    pp.set_defaults(fn=cmd_predict)

    ps = sub.add_parser("serve", help="persistent micro-batching inference "
                                      "daemon (Unix socket or TCP)")
    _add_common(ps)
    ps.add_argument("--socket", required=True,
                    help="Unix-socket path, or host:port for TCP")
    ps.add_argument("--artifact", default=None,
                    help="serve a torch.export artifact (.drexpt); "
                         "otherwise the checkpoint selected by the common "
                         "flags")
    ps.add_argument("--window_ms", type=float, default=2.0,
                    help="micro-batching window: after the first queued "
                         "request, wait at most this long for more before "
                         "dispatching (latency/throughput knob)")
    ps.add_argument("--max_queue", type=int, default=None,
                    help="bound on queued-but-undispatched requests; "
                         "arrivals beyond it are shed with an immediate "
                         "'overloaded' error response (default "
                         "8*max_batch; 0 = unbounded)")
    ps.add_argument("--stats_interval", type=float, default=30.0,
                    help="seconds between traffic log lines")
    ps.add_argument("--batch_buckets", default=None,
                    help="comma-separated dispatch-size ladder (e.g. "
                         "1,8,64): each micro-batch is padded to the "
                         "smallest bucket that fits instead of always to "
                         "batch_size, so a lone request pays batch-1 "
                         "device latency; one warm-up per bucket at "
                         "startup (checkpoint-backed predictors only)")
    ps.add_argument("--selected_step", type=int, default=-1)
    ps.add_argument("--quantize", action="store_true",
                    help="serve the int8-weight graph")
    ps.add_argument("--use_ema", action="store_true")
    ps.add_argument("--use_best", action="store_true")
    ps.add_argument("--ema_decay", type=float, default=None)
    ps.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    device = getattr(args, "device", None)
    if device is not None:
        from densereg_torch.utils.device import default_device

        default_device(device)   # raises where there is no such device
    n = local_group_size(args) if hasattr(args, "mesh") else 0
    if n:
        return launch_local_group(argv, n, device)
    grouped = hasattr(args, "coordinator_address") and (
        args.coordinator_address is not None
        or "DENSEREG_NUM_PROCESSES" in os.environ)
    if grouped:
        # before anything touches the card: under NCCL each rank takes its
        # own card first
        from densereg_torch.parallel import initialize_distributed

        initialize_distributed(args.coordinator_address, args.num_processes,
                               args.process_id,
                               backend="nccl" if device == "cuda" else "gloo")
    try:
        return args.fn(args)
    finally:
        if grouped:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
