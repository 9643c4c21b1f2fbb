"""Find the camera cell's knee: the highest number of cameras at which the
serving daemon keeps its completions up with the offered frames, with no
sheds, errors or lost answers and no backlog growing through the run.

    python3 benchmark/knee_sweep.py --config um_v1-s2f128-nyu14-bf16 \\
        --traffic cameras30fps --cameras 8,16,24,32 [--seconds 10] [--seed 1]

One daemon is built as the cell builds it; each camera count is a run of
the cell's load generator against it. One JSON line a count: offered and
completed frames/s, sheds, errors, lost, the latency median and 95th
percentile, the median latency of the run's first and last two seconds
(a backlog that grows shows as the second far above the first), and how
late the load generator ran. The last line names the knee and the cell's
camera count at four fifths of it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

BENCH = os.path.dirname(os.path.abspath(__file__))
sys.path.append(os.path.dirname(BENCH))


def sweep(config: str, traffic: str, counts, seconds: float, seed: int,
          device="cuda", config_overrides=None, traffic_overrides=None):
    import numpy as np

    import common
    from drivers.cameras import Session

    cfg, tr = common.load_parts(config, traffic)
    cfg = dict(cfg, **(config_overrides or {}))
    tr = dict(tr, **(traffic_overrides or {}))
    rows = []
    with tempfile.TemporaryDirectory(prefix="bench-knee-") as root:
        session = Session(cfg, tr, seed, device, root)
        try:
            for n in counts:
                totals, rec, diff = session.drive(n, seconds, seed + n)
                ok = rec["status"] == 0
                due, lat = rec["due_s"], rec["latency_s"]
                head = lat[ok & (due < 2.0)]
                tail = lat[ok & (due > seconds - 2.0)]
                row = dict(
                    cameras=n, offered_per_s=totals["offered_per_s"],
                    completed_per_s=float(ok.sum()) / seconds,
                    sheds=diff["sheds"], errors=totals["errors"],
                    lost=totals["lost"],
                    latency_p50_ms=totals["latency_p50_ms"],
                    latency_p95_ms=totals["latency_p95_ms"],
                    first_2s_p50_ms=float(np.median(head) * 1e3)
                    if len(head) else None,
                    last_2s_p50_ms=float(np.median(tail) * 1e3)
                    if len(tail) else None,
                    frames_per_batch=diff["batched_frames"]
                    / max(diff["batches"], 1),
                    send_late_ms=totals["send_late_ms"])
                row["keeps_up"] = bool(
                    totals["ok"] == totals["attempted"]
                    and row["last_2s_p50_ms"] is not None
                    and row["last_2s_p50_ms"] <= 2.0 * row["first_2s_p50_ms"]
                    + 20.0)
                rows.append(row)
                print(json.dumps(row), flush=True)
        finally:
            session.close()
    knee = None     # the highest count below which every count kept up
    for r in sorted(rows, key=lambda r: r["cameras"]):
        if not r["keeps_up"]:
            break
        knee = r["cameras"]
    return rows, knee


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--cameras", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    counts = [int(c) for c in args.cameras.split(",")]
    _, knee = sweep(args.config, args.traffic, counts, args.seconds,
                    args.seed)
    print(json.dumps({"knee_cameras": knee,
                      "cell_cameras": None if knee is None
                      else int(0.8 * knee)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
