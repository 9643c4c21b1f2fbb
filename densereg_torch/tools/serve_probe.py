"""Load-test the port's serving daemon (``densereg_torch.serve``), the
counterpart of ``tools/serve_probe.py``.

Drives N pipelined requests at a running server (or self-hosts one) and
reports client-side latency percentiles and throughput, with the server's
own batching counts: one JSON row a pipelining depth.

    # against a running daemon
    python -m densereg_torch.tools.serve_probe --socket 127.0.0.1:5555

    # self-hosted from an export artifact (densereg_torch.export)
    python -m densereg_torch.tools.serve_probe --artifact model.drexpt \\
        --requests 512 --window_ms 2 --inflight 64

    # self-hosted at a net config with seeded weights (serving latency and
    # throughput do not depend on the weight values)
    python -m densereg_torch.tools.serve_probe --net s2f128 --max_batch 256 \\
        --quantize --requests 1024 --inflight 1 16 64 256

``--inflight`` is the client's pipelining depth: how many requests are
kept outstanding (the server can only micro-batch what is in flight at
once, so the sweep goes from batch-1 latency to full-batch throughput).
A self-hosted server runs on ``--device`` (the card unless ``cpu`` is
asked for) and listens on TCP ``127.0.0.1`` at a free port. Each row's
``row_mean_batch`` counts the frames and batches of that row alone, from
integer differences of the server's counters.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time

import numpy as np


def _percentile(sorted_vals, p):
    if not sorted_vals:
        return 0.0
    return sorted_vals[min(len(sorted_vals) - 1,
                           int(p * len(sorted_vals)))]


def _frames(stats: dict) -> int:
    """The server's count of batched frames (``stats()`` gives it as
    ``mean_batch * batches``, exact to a rounding)."""
    return round(stats["mean_batch"] * stats["batches"])


def run_probe(address: str, requests: int, inflight: int,
              frame_hw, rng) -> dict:
    from densereg_torch.serve import Client

    h, w = frame_hw
    # integer-mm depth, so the u16 wire is exact; one frame for every
    # request: the probe measures the serving path, not input diversity
    frame = rng.integers(300, 500, (h, w)).astype(np.uint16)
    bbx = [h // 4, w // 4, 3 * h // 4, 3 * w // 4, 600.0]

    with Client(address) as c:
        if not c.ping():
            raise SystemExit(f"server at {address} did not answer ping")
        c.predict(frame, bbx)   # warm the client path
        # the server's counters before the row, so that the row reports its
        # own coalescing and not the lifetime mean of a sweep's server
        s0 = c.stats()
        t_submit = {}
        lat = []
        t0 = time.perf_counter()
        sent = recvd = 0
        while recvd < requests:
            while sent < requests and sent - recvd < inflight:
                rid = c.submit(frame, bbx, rid=sent)
                t_submit[rid] = time.perf_counter()
                sent += 1
            resp = c.recv()
            if "error" in resp:
                raise SystemExit(f"server error: {resp['error']}")
            lat.append(time.perf_counter() - t_submit.pop(resp["id"]))
            recvd += 1
        wall = time.perf_counter() - t0
        stats = c.stats()

    lat_ms = sorted(v * 1e3 for v in lat)
    row_batches = stats["batches"] - s0["batches"]
    row_frames = _frames(stats) - _frames(s0)
    return {
        "requests": requests,
        "inflight": inflight,
        "fps": round(requests / wall, 1),
        "p50_ms": round(_percentile(lat_ms, 0.50), 2),
        "p90_ms": round(_percentile(lat_ms, 0.90), 2),
        "p99_ms": round(_percentile(lat_ms, 0.99), 2),
        "row_mean_batch": round(row_frames / max(row_batches, 1), 2),
        "server_mean_batch": round(stats["mean_batch"], 2),
        "server_batches": stats["batches"],
    }


def net_config(desc: str):
    """``NetConfig`` of ``desc`` = s<stack>f<fea> (e.g. s2f128, the shape of
    the reference's released ICVL model), 16 joints, 128x128 input."""
    from densereg_torch.config import NetConfig

    m = re.fullmatch(r"s(\d+)f(\d+)", desc)
    if not m:
        raise SystemExit(f"--net must look like s2f128, got {desc!r}")
    return NetConfig(num_stack=int(m.group(1)), num_fea=int(m.group(2)),
                     num_joint=16, input_hw=(128, 128))


def net_predictor(desc: str, max_batch: int, quantize: bool,
                  batch_buckets=None, device="cuda"):
    """A ``Predictor`` at ``net_config(desc)`` on seeded weights
    (``models.bridge.init_variables``, seed 0) and the ICVL camera;
    ``quantize`` serves the int8 net with dynamic activation scales."""
    from densereg_torch.config import CameraConfig
    from densereg_torch.models import init_variables
    from densereg_torch.serving import Predictor

    net_cfg = net_config(desc)
    icvl = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
    return Predictor(init_variables(net_cfg, seed=0), net_cfg, icvl,
                     max_batch=max_batch, quantize=quantize,
                     batch_buckets=batch_buckets, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--socket", default=None,
                    help="address of a RUNNING server (Unix path or "
                         "host:port)")
    ap.add_argument("--artifact", default=None,
                    help="self-host this torch.export artifact (.drexpt) "
                         "instead")
    ap.add_argument("--net", default=None,
                    help="self-host a seeded net at this config (e.g. "
                         "s2f128) instead of a checkpoint/artifact")
    ap.add_argument("--max_batch", type=int, default=64,
                    help="--net mode: server-side micro-batch capacity")
    ap.add_argument("--quantize", action="store_true",
                    help="--net mode: serve the int8-weight graph")
    ap.add_argument("--batch_buckets", default=None,
                    help="--net mode: comma-separated dispatch-size ladder "
                         "(e.g. 1,8,64); lone requests ride the smallest "
                         "bucket instead of padding to max_batch")
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--inflight", type=int, default=None, nargs="+",
                    help="pipelining depth(s) to sweep (default: 1, "
                         "max_batch)")
    ap.add_argument("--window_ms", type=float, default=2.0,
                    help="self-hosted server batching window")
    ap.add_argument("--frame_hw", type=int, nargs=2, default=None,
                    help="frame size when probing a remote server "
                         "(default 240 320)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where a self-hosted server runs: the card "
                         "(default) or the CPU")
    args = ap.parse_args(argv)
    if not (args.socket or args.artifact or args.net):
        ap.error("need --socket, --artifact, or --net")

    rng = np.random.default_rng(0)
    server = None
    try:
        if args.artifact or args.net:
            from densereg_torch.serve import Server
            from densereg_torch.utils.device import default_device

            device = default_device(args.device)   # raises without one
            if args.artifact:
                from densereg_torch.export import load_exported
                pred = load_exported(args.artifact, device=device)
                h, w = pred.frame_hw
            else:
                buckets = (tuple(int(v) for v in
                                 args.batch_buckets.split(",") if v)
                           if args.batch_buckets else None)
                pred = net_predictor(args.net, args.max_batch,
                                     args.quantize, buckets, device)
                h, w = int(pred.camera.h), int(pred.camera.w)
            # run every (bucket, dtype) program once, the kernels' build
            # included, before timing anything
            pred.warmup(with_u16=pred.accepts_u16)
            server = Server(pred, "127.0.0.1:0", window_ms=args.window_ms)
            address = server.address
            frame_hw = (h, w)
            default_sweep = [1, pred.max_batch]
        else:
            address = args.socket
            frame_hw = tuple(args.frame_hw or (240, 320))
            default_sweep = [1, 64]

        for depth in (args.inflight or default_sweep):
            res = run_probe(address, args.requests, depth, frame_hw, rng)
            print(json.dumps(res), flush=True)
    finally:
        if server is not None:
            server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
