"""Streaming evaluation: pre-cropped batches -> normalize, network, decode
-> result dump.

Mirrors ``densereg_tpu/eval/loop.py``: ``make_infer_fn`` builds the
inference of one batch (the decode runs the fused kernel on a CUDA
device), and ``evaluate_stream`` feeds it a batch stream, writes the
predictions and the error curve, and stops exactly at ``exact_num``
frames. The multi-process evaluation (``evaluate_multihost``) is not
ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

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
