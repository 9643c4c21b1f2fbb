"""Live cameras on the serving daemon: ``serve.Server`` over a
``serving.Predictor`` with the traffic's buckets and batching window,
listening on TCP at a free port of 127.0.0.1, and an open loop of
``cameras`` cameras at ``fps`` from ``benchmark/loadgen.py`` in a process
of its own.

The window is the load generator's schedule, ``--seconds`` long; its
latencies are the end-to-end metrics. The daemon's own counters are read
at the window's edges. Every answer that came is compared with the
reference's joints for its frame once the window has closed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

import common
from drivers import batch
from reference import net
from reference import serving as ref_serving

LOADGEN = os.path.join(common.BENCH, "loadgen.py")


class Session:
    """Frames on disk for the load generator, the predictor warmed at its
    buckets, and the daemon in front of it."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device, root: str,
                 quantize: bool = False):
        from densereg_torch.serve import Server

        self.cfg, self.tr, self.root = cfg, tr, root
        (pred, self.depth, self.boxes, self.params, self.stats,
         self.cam) = batch.serving_setup(
            cfg, tr["pool_frames"], seed, device, max_batch=tr["max_batch"],
            batch_buckets=tr["batch_buckets"], quantize=quantize)
        self.buckets = pred.batch_buckets
        for b in self.buckets:               # the cell's shapes: uint16
            pred(self.depth[:b], self.boxes[:b])
        self.frames_path = os.path.join(root, "frames.npy")
        self.boxes_path = os.path.join(root, "boxes.npy")
        np.save(self.frames_path, self.depth)
        np.save(self.boxes_path, self.boxes)
        self.server = Server(pred, "127.0.0.1:0", window_ms=tr["window_ms"])

    def counters(self) -> dict:
        s = self.server.stats()
        return {"batches": s["batches"],
                "batched_frames": int(round(s["mean_batch"] * s["batches"])),
                "sheds": s["sheds"], "errors": s["errors"]}

    def drive(self, cameras: int, seconds: float, seed: int, on_go=None):
        """Run the load generator, the traffic's ``warm_s`` of load first;
        ``on_go`` is called as the measured schedule starts. Returns
        ``(totals, record, counter differences over the schedule)``."""
        out = os.path.join(self.root, f"loadgen-{seed}.npz")
        cmd = [sys.executable, LOADGEN, "--address", self.server.address,
               "--cameras", str(cameras), "--fps", str(self.tr["fps"]),
               "--seconds", str(seconds), "--seed", str(seed),
               "--frames", self.frames_path, "--boxes", self.boxes_path,
               "--joints", str(self.cfg["num_joint"]), "--out", out,
               "--grace", str(self.tr["grace_s"]),
               "--warm", str(self.tr["warm_s"])]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, text=True, env=env)
        try:
            if proc.stdout.readline().strip() != "ready":
                raise RuntimeError("the load generator did not connect")
            proc.stdin.write("go\n")
            proc.stdin.flush()
            if proc.stdout.readline().strip() != "window":
                raise RuntimeError("the load generator did not warm up")
            before = self.counters()
            if on_go is not None:
                on_go()
            line, _ = proc.communicate(timeout=seconds + self.tr["grace_s"]
                                       + 60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if proc.returncode != 0:
            raise RuntimeError(f"the load generator exited {proc.returncode}")
        after = self.counters()
        diff = {k: after[k] - before[k] for k in after}
        with np.load(out) as z:
            record = {k: z[k] for k in z.files}
        os.unlink(out)
        return json.loads(line.strip().splitlines()[-1]), record, diff

    def readings(self, record: dict) -> dict:
        """Every answer against the reference's joints for its frame. The
        daemon pads each batch to a bucket, and cuDNN picks its algorithm
        by shape, so the reference computes each frame at every bucket
        size and an answer is held to the nearest of those: a bucket's
        computation is one the program may rightly have made, and a wrong
        answer is near none of them."""
        folded = net.fold(self.params, self.stats)
        refs = np.stack([ref_serving.predict(
            self.cfg, folded, self.depth, self.boxes, self.cam,
            batch.dtype_of(self.cfg), block=b) for b in self.buckets])
        ok = record["status"] == 0
        xyz = record["xyz"][ok]
        gaps = np.stack([common.joint_gaps(xyz, r[record["frame"][ok]])
                         for r in refs])
        nearest = gaps.max(axis=2).argmin(axis=0)
        return common.serving_readings(gaps[nearest, np.arange(len(xyz))])

    def close(self) -> None:
        self.server.shutdown()


class DispatchTrace:
    """The profiler inside the daemon's batcher thread, which launches the
    device work (a profiler started in another thread sees none of it):
    the predictor's dispatch is wrapped, and the first dispatch
    ``delay_s`` after the window opens starts the profiler and a
    ``bench.window`` range; the first that starts ``trace_s`` later ends
    both after it."""

    def __init__(self, cell, pred, delay_s: float, trace_s: float):
        self.cell, self.inner = cell, pred._dispatch
        self.thread = None
        self.delay_s, self.trace_s = delay_s, trace_s
        self.t0 = self.prof = self.window = None
        self.done = False
        pred._dispatch = self.dispatch

    def open(self):
        self.t0 = time.monotonic()

    def dispatch(self, frames, bbxs):
        now = time.monotonic()
        if (self.t0 is not None and not self.done and self.prof is None
                and now >= self.t0 + self.delay_s):
            self.thread = threading.get_ident()
            self.prof = self.cell.start_profiler()
            self.window = torch.autograd.profiler.record_function(
                "bench.window")
            self.window.__enter__()
        out = self.inner(frames, bbxs)
        if self.prof is not None and now >= (self.t0 + self.delay_s
                                             + self.trace_s):
            self.close()
        return out

    def close(self):
        """End the trace; only the thread that started the profiler can
        stop it, so from another (the load ended first) the trace is
        dropped and the run reports no traced metric."""
        if self.prof is not None and self.thread == threading.get_ident():
            self.window.__exit__(None, None, None)
            self.cell.stop_profiler(self.prof)
        elif self.prof is not None:
            print("the daemon's trace did not end inside its window: no "
                  "traced metrics", file=sys.stderr)
        self.prof = None
        self.done = True


def run(cell):
    cfg, tr = cell.config, cell.traffic
    session = Session(cfg, tr, cell.seed, cell.device, cell.scratch)
    trace = (DispatchTrace(cell, session.server.predictor,
                           tr["trace_delay_s"], tr["trace_s"])
             if cell.trace else None)

    def go():
        cell.window_open()
        if trace is not None:
            trace.open()

    try:
        totals, record, diff = session.drive(tr["cameras"], cell.seconds,
                                             cell.seed, on_go=go)
        cell.window_close()
    finally:
        session.close()
        if trace is not None:
            trace.close()
    print(f"load generator: {json.dumps(totals)}", file=sys.stderr)
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = dict(session.readings(record), lost_answers=totals["lost"])
    return cell.outcome(
        attempted=totals["attempted"],
        failed=totals["errors"] + totals["lost"],
        end_to_end={"latency_p50_ms": totals["latency_p50_ms"],
                    "latency_p95_ms": totals["latency_p95_ms"]},
        readings=readings, counters=diff)
