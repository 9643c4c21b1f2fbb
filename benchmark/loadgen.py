"""Open-loop camera load on the serving daemon, in a process of its own
(numpy and sockets only).

    python3 benchmark/loadgen.py --address 127.0.0.1:PORT --cameras N \\
        --fps 30 --seconds S --seed SEED --frames F.npy --boxes B.npy \\
        --out R.npz [--grace 10]

Each camera has its own connection and sends single frames with their
boxes at ``fps``, from a seeded phase in ``[0, 1/fps)``, cycling through
the frame pool from a seeded offset. Request ``k`` of a camera is due at
``start + phase + k / fps``; it is sent then, whatever the state of earlier
ones, and its latency runs from that due time to its answer's arrival, so a
stall counts against every request it delays. An answer that is an error
(a shed: ``overloaded``) counts as failed; a request with no answer
``grace`` seconds after the last one was due counts as lost.

Protocol with the parent: after connecting, one line ``ready`` on
standard output; the load starts when ``go`` arrives on standard input:
``--warm`` seconds of it unrecorded, then a line ``window`` and the
schedule. At the end: the per-request record in ``--out`` (due, latency,
status, frame index, joints) and one JSON line of totals, with how late the
sender threads ran (``send_late_ms``), on standard output.

The wire framing is a frozen copy of the daemon's: a 4-byte big-endian
length, a JSON header, and the raw little-endian uint16 frame; answers are
a length and a JSON body.
"""

from __future__ import annotations

import argparse
import json
import socket
import struct
import sys
import threading
import time

import numpy as np

HDR = struct.Struct(">I")
OK, ERROR, LOST = 0, 1, 2


def recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def request_bytes(rid, frame: np.ndarray, bbx) -> bytes:
    header = json.dumps({"id": rid, "h": int(frame.shape[0]),
                         "w": int(frame.shape[1]), "dtype": "u16",
                         "bbx": [float(v) for v in bbx]}).encode()
    return (HDR.pack(len(header)) + header
            + np.ascontiguousarray(frame, "<u2").tobytes())


def read_answer(sock: socket.socket) -> dict:
    (n,) = HDR.unpack(recv_exact(sock, 4))
    return json.loads(recv_exact(sock, n).decode())


def schedule(cameras: int, fps: float, seconds: float, seed: int,
             pool: int):
    """Per camera, the due offsets (s from the start) and frame indices of
    its requests: a seeded phase and pool offset, one request every
    ``1 / fps`` while it is due inside ``seconds``."""
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 1.0 / fps, cameras)
    offset = rng.integers(0, pool, cameras)
    out = []
    for c in range(cameras):
        n = int(np.ceil((seconds - phase[c]) * fps))
        k = np.arange(max(n, 0))
        out.append((phase[c] + k / fps, (offset[c] + k) % pool))
    return out


class Camera:
    """One camera's connection, its sender and its receiver."""

    def __init__(self, address, cam_id, due, frame_idx, frames, boxes, jnt):
        host, port = address.rsplit(":", 1)
        self.sock = socket.create_connection((host, int(port)))
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.cam_id, self.due, self.frame_idx = cam_id, due, frame_idx
        self.frames, self.boxes = frames, boxes
        n = len(due)
        self.latency = np.full(n, np.nan)
        self.status = np.full(n, LOST, np.int8)
        self.xyz = np.full((n, 3 * jnt), np.nan, np.float32)
        self.late = np.zeros(n)
        self.answered = 0

    def send_all(self, t0: float, stop: threading.Event) -> None:
        for k, (due, fi) in enumerate(zip(self.due, self.frame_idx)):
            wait = t0 + due - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self.late[k] = time.monotonic() - (t0 + due)
            try:
                self.sock.sendall(request_bytes([self.cam_id, k],
                                                self.frames[fi],
                                                self.boxes[fi]))
            except OSError:
                return
            if stop.is_set():
                return

    def receive_all(self, t0: float) -> None:
        while self.answered < len(self.due):
            try:
                ans = read_answer(self.sock)
            except (OSError, ConnectionError, ValueError):
                return
            now = time.monotonic()
            k = int(ans["id"][1])
            self.latency[k] = now - (t0 + self.due[k])
            if "xyz" in ans:
                self.status[k] = OK
                self.xyz[k] = ans["xyz"]
            else:
                self.status[k] = ERROR
            self.answered += 1

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def warm(cams, fps, seconds):
    """The same load for ``seconds`` before the window, unrecorded: each
    camera sends one frame every ``1 / fps`` and reads its answer."""
    def one(cam):
        t0 = time.monotonic()
        for k in range(int(seconds * fps)):
            wait = t0 + k / fps + cam.due[0] - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            cam.sock.sendall(request_bytes(["warm", k], cam.frames[0],
                                           cam.boxes[0]))
            read_answer(cam.sock)

    threads = [threading.Thread(target=one, args=(c,), daemon=True)
               for c in cams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run(address, cameras, fps, seconds, seed, frames, boxes, jnt, grace,
        go=None, warm_s=0.0, window=None):
    """Drive the schedule; returns ``(totals, record)``. ``go``, where
    given, is called once every camera is connected and returns when the
    load may start; ``warm_s`` seconds of it are sent before the window,
    and ``window``, where given, is called as the window opens."""
    plan = schedule(cameras, fps, seconds, seed, len(frames))
    cams = [Camera(address, c, due, fi, frames, boxes, jnt)
            for c, (due, fi) in enumerate(plan)]
    if go is not None:
        go()
    if warm_s > 0:
        warm(cams, fps, warm_s)
    if window is not None:
        window()
    t0 = time.monotonic() + 0.05
    stop = threading.Event()
    threads = []
    for cam in cams:
        threads.append(threading.Thread(target=cam.send_all, args=(t0, stop),
                                        daemon=True))
        threads.append(threading.Thread(target=cam.receive_all, args=(t0,),
                                        daemon=True))
    for t in threads:
        t.start()
    deadline = t0 + seconds + grace
    for t in threads:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))
    stop.set()
    for cam in cams:
        cam.close()
    for t in threads:
        t.join(timeout=5.0)
    status = np.concatenate([c.status for c in cams])
    latency = np.concatenate([c.latency for c in cams])
    late = np.concatenate([c.late for c in cams])
    miss = (seconds + grace) * 1e3
    lat_ms = np.where(status == OK, latency * 1e3, miss)
    totals = {
        "attempted": int(len(status)),
        "ok": int((status == OK).sum()),
        "errors": int((status == ERROR).sum()),
        "lost": int((status == LOST).sum()),
        "offered_per_s": len(status) / seconds,
        "latency_p50_ms": float(np.percentile(lat_ms, 50)) if len(lat_ms) else 0.0,
        "latency_p95_ms": float(np.percentile(lat_ms, 95)) if len(lat_ms) else 0.0,
        "send_late_ms": {"p50": float(np.percentile(late, 50) * 1e3),
                         "p99": float(np.percentile(late, 99) * 1e3),
                         "max": float(late.max() * 1e3)} if len(late) else {},
    }
    record = {"status": status, "latency_s": latency,
              "due_s": np.concatenate([c.due for c in cams]),
              "frame": np.concatenate([c.frame_idx for c in cams]),
              "xyz": np.concatenate([c.xyz for c in cams])}
    return totals, record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--address", required=True)
    ap.add_argument("--cameras", type=int, required=True)
    ap.add_argument("--fps", type=float, default=30.0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", required=True)
    ap.add_argument("--boxes", required=True)
    ap.add_argument("--joints", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--grace", type=float, default=10.0)
    ap.add_argument("--warm", type=float, default=0.0,
                    help="seconds of the same load sent before the window")
    args = ap.parse_args(argv)
    frames = np.load(args.frames, mmap_mode="r")
    boxes = np.load(args.boxes)

    def go():
        print("ready", flush=True)
        if sys.stdin.readline().strip() != "go":
            raise SystemExit("expected go")

    totals, record = run(args.address, args.cameras, args.fps, args.seconds,
                         args.seed, frames, boxes, args.joints, args.grace,
                         go, args.warm, lambda: print("window", flush=True))
    np.savez(args.out, **record)
    print(json.dumps(totals), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
