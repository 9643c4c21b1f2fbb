"""Streaming evaluation: pre-cropped batches -> normalize, network, decode
-> result dump.

Mirrors ``densereg_tpu/eval/loop.py``: ``make_infer_fn`` builds the
inference of one batch (the decode runs the fused kernel on a CUDA
device), and ``evaluate_stream`` feeds it a batch stream, writes the
predictions and the error curve, and stops exactly at ``exact_num``
frames. ``evaluate_multihost`` runs it in several processes, each on its
own shards, and merges the results on rank 0.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from densereg_torch import decode as decode_mod
from densereg_torch.config import EvalConfig, NetConfig
from densereg_torch.eval.metrics import max_joint_error, summarize_percentages
from densereg_torch.eval.writer import ResultWriter, write_error_curve
from densereg_torch.models import DenseRegNet, from_flax
from densereg_torch.preprocess import method2_resize, norm_dm


def make_infer_fn(net_cfg: NetConfig, ecfg: EvalConfig = EvalConfig(),
                  device="cuda") -> Callable:
    """Returns ``infer(variables_or_module, dms, cfgs, coms)`` -> xyz
    ``(b, 3j)`` mm on ``device``.

    ``dms`` are raw-mm cropped depth maps ``(b, H, W, 1)`` (float32 or
    uint16; arrays or tensors); ``cfgs`` ``(b, 6)``; ``coms`` ``(b, 3)``.
    ``variables_or_module`` is a :class:`DenseRegNet` on ``device`` or a
    Flax-layout tree, which is converted (``models.from_flax``) on every
    call: pass the module where calls repeat.
    """
    device = torch.device(device)
    out_h, out_w = net_cfg.output_hw

    @torch.inference_mode()
    def infer(variables_or_module, dms, cfgs, coms):
        net = variables_or_module
        if not isinstance(net, DenseRegNet):
            net = from_flax(net, net_cfg).to(device)
        dms = torch.as_tensor(dms, device=device).to(torch.float32)
        cfgs = torch.as_tensor(cfgs, dtype=torch.float32, device=device)
        coms = torch.as_tensor(coms, dtype=torch.float32, device=device)
        normed = norm_dm(dms, coms)
        outs = net(normed)
        tiny = method2_resize(normed, out_h, out_w)
        res = decode_mod.decode_poses(outs["hm"][-1], outs["hm3"][-1],
                                      outs["um"][-1], tiny, cfgs, coms, ecfg)
        return res["xyz"]

    return infer


def evaluate_stream(infer_fn, variables, batches: Iterable[dict],
                    exact_num: int, result_path: Optional[str] = None,
                    error_path: Optional[str] = None, log_every: int = 101,
                    log_fn=print) -> dict:
    """Run ``infer_fn(variables, dm, cfg, com)`` over a batch stream and
    dump reference-format results.

    Args:
      batches: iterable of dicts with ``dm``, ``cfg``, ``com``, ``name`` and
        optionally ``pose`` (ground truth for the error curve). Frames past
        ``exact_num`` are dropped, and no batch is taken from the stream or
        run once ``exact_num`` frames have been issued (the reference stops
        at ``exact_num``, reference model/test_model.py:79-83).
    Returns:
      dict with ``num_frames``, ``max_errors`` (list, empty without ground
      truth), ``percentages``, ``fps``.
    """
    writer = ResultWriter(result_path) if result_path else None
    max_errors = []
    n_done = 0
    t0 = time.time()

    def consume(xyz_dev, batch, step):
        """Copy one issued batch's result to the host (this waits for it;
        the next batch is already issued) and write and score it."""
        nonlocal n_done
        take = min(len(xyz_dev), exact_num - n_done)
        xyz = torch.as_tensor(xyz_dev)[:take].cpu()
        if batch.get("pose") is not None:
            gt = torch.as_tensor(batch["pose"])[:take].cpu()
            max_errors.extend(max_joint_error(xyz, gt).tolist())
        names = batch.get("name")
        if writer is not None and names is not None:
            writer.write_batch(names[:take], xyz.numpy())
        n_done += take
        if log_every and step % log_every == 0:
            dt = time.time() - t0
            log_fn(f"[eval] {n_done}/{exact_num} frames, "
                   f"{n_done / max(dt, 1e-9):.1f} fps")

    # Double-buffered: batch k+1 is issued (the device's stream runs it
    # behind batch k) before batch k's result is copied to the host.
    pending = None
    n_issued = 0
    stream = iter(batches)
    try:
        step = 0
        while n_issued < exact_num:
            batch = next(stream, None)
            if batch is None:
                break
            xyz_dev = infer_fn(variables, batch["dm"], batch["cfg"],
                               batch["com"])
            n_issued += len(xyz_dev)
            if pending is not None:
                consume(*pending)
            pending = (xyz_dev, batch, step)
            step += 1
        if pending is not None:
            consume(*pending)
    finally:
        if writer is not None:
            writer.close()
    if error_path and max_errors:
        write_error_curve(max_errors, error_path)
    dt = time.time() - t0
    return {
        "num_frames": n_done,
        "max_errors": max_errors,
        "percentages": summarize_percentages(max_errors) if max_errors else {},
        "fps": n_done / max(dt, 1e-9),
    }


def evaluate_multihost(infer_fn, variables, spec, batch_size, input_hw,
                       result_path, error_path=None, log_fn=print,
                       host_preprocess: bool = False,
                       wire_dtype: str = "float32", mesh=None,
                       device="cuda") -> dict:
    """Multi-process evaluation, shard-partitioned, merged on rank 0 (the
    port of ``densereg_tpu/eval/loop.py::evaluate_multihost``).

    Each process of ``mesh``'s group (default: the default process group)
    evaluates a contiguous range of the deduplicated shard list on its own
    device (``mesh.devices[0]``, else ``device``), with no collective but
    two barriers, and writes ``<result_path>.part<k>`` and its errors;
    rank 0 then concatenates the parts in shard order, so the merged dump
    is line for line that of one process. The ``exact_num`` truncation
    holds globally: each process's budget is clamped against the frames
    that precede its range in dataset order.

    Returns the merged report on rank 0 and each other process's local
    report. ``result_path`` is required (the part files carry the merge)
    and must be the same on every process and on a file system that all
    share: derive it from shared state (a checkpoint's step), never from a
    process's clock.
    """
    import torch.distributed as dist

    from densereg_torch.data.pipeline import TestPipeline

    if not result_path:
        raise ValueError("evaluate_multihost requires result_path "
                         "(part files are the merge transport)")
    group = None if mesh is None else mesh.group
    if mesh is not None:
        device = mesh.devices[0]
    nproc = dist.get_world_size(group)
    host = dist.get_rank(group)

    readers = TestPipeline(spec, batch_size, input_hw,
                           device="cpu").unique_readers()
    counts = [len(r) for r in readers]
    base, rem = divmod(len(readers), nproc)
    lo = host * base + min(host, rem)
    hi = lo + base + (1 if host < rem else 0)
    cum_before = sum(counts[:lo])
    local_total = sum(counts[lo:hi])
    local_exact = max(
        0, min(cum_before + local_total, spec.exact_num) - cum_before)
    log_fn(f"[eval mh] process {host}/{nproc}: shards [{lo},{hi}) "
           f"({local_exact} frames)")

    pipe = TestPipeline(spec, batch_size, input_hw,
                        host_preprocess=host_preprocess,
                        wire_dtype=wire_dtype, shard_slice=slice(lo, hi),
                        device=device)
    report = evaluate_stream(infer_fn, variables, iter(pipe), local_exact,
                             f"{result_path}.part{host}", None, log_fn=log_fn)
    np.save(f"{result_path}.errs{host}.npy",
            np.asarray(report["max_errors"], np.float64))

    dist.barrier(group)
    if host == 0:
        merged_errors = []
        n_merged = 0
        with open(result_path, "w") as out:
            for h in range(nproc):
                part = f"{result_path}.part{h}"
                if not os.path.exists(part):
                    # every process writes its part (maybe empty) before
                    # the barrier: a missing one means result_path is not
                    # on a file system that all share
                    raise FileNotFoundError(
                        f"{part} missing after the parts barrier: "
                        f"result_path must be on a filesystem shared by "
                        f"all {nproc} processes")
                with open(part) as f:
                    for line in f:
                        out.write(line)
                        n_merged += 1
        for h in range(nproc):
            merged_errors.extend(np.load(f"{result_path}.errs{h}.npy")
                                 .tolist())
        expected = min(sum(counts), spec.exact_num)
        if n_merged != expected:
            raise RuntimeError(
                f"merged result has {n_merged} frames, expected {expected}: "
                f"a process evaluated a wrong shard range or dropped frames")
        if error_path and merged_errors:
            write_error_curve(merged_errors, error_path)
        report = {
            "num_frames": n_merged,
            "max_errors": merged_errors,
            "percentages": (summarize_percentages(merged_errors)
                            if merged_errors else {}),
            "fps": report["fps"],  # this process's rate; parts ran at once
        }
    # keep every process until the merge is on disk
    dist.barrier(group)
    return report
