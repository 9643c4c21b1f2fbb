"""Persistent low-latency serving daemon with cross-client micro-batching.

A copy of ``densereg_tpu/serve.py`` (numpy and sockets) pointed at the
port's ``serving.Predictor``. One process owns the card and keeps the net
resident; the daemon micro-batches CONCURRENT client requests into
dispatches of the predictor, each padded to the smallest of its
``batch_buckets`` that fits (``max_batch`` at most), so a lone request
under light load pays for a small batch and a busy daemon fills large ones.

The device pipeline is double-buffered across micro-batches: the batcher
thread stacks, enqueues dispatch k+1 and queues its result's copy into
pinned host memory behind it (a CUDA event marks the copy's end), while the
completer thread waits on dispatch k's event alone, so host framing and
transfer overlap device compute. A ``.cpu()`` in the completer would wait
for everything queued on the stream, dispatch k+1 included.

Wire protocol (length-framed, language-neutral, works over a Unix socket or
TCP):

  request:   >I header_len | header JSON (utf-8) | raw frame payload
      header: {"id": <any json>, "h": H, "w": W, "dtype": "u16"|"f32",
               "bbx": [top, left, bottom, right, depth_threshold_mm]}
      payload: H*W little-endian values (2 bytes u16 / 4 bytes f32), raw
               depth in mm — the same full-frame contract as
               ``Predictor.__call__``.
      Control requests carry no payload: {"cmd": "ping"} and
      {"cmd": "stats"}.
  response:  >I len | JSON {"id": ..., "xyz": [3*J floats, camera mm]}
             or {"id": ..., "error": "..."} (the connection stays usable
             after a semantic error; only framing corruption closes it).
             A client flooding faster than the device drains gets
             {"id": ..., "error": "overloaded"} immediately (load shedding:
             the pending-request queue is bounded at ``max_queue`` so host
             memory and tail latency stay bounded; sheds are counted in
             ``stats()["sheds"]`` — retry with backoff or lower the
             in-flight depth).

``u16`` requests halve the client-to-server and host-to-device bytes;
integer-mm depth is exactly representable, so their results are
bit-identical to f32 requests.
"""

from __future__ import annotations

import collections
import json
import os
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

_HDR = struct.Struct(">I")
_DTYPES = {"u16": np.dtype("<u2"), "f32": np.dtype("<f4")}


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _read_msg(sock: socket.socket) -> Tuple[dict, bytes]:
    (hlen,) = _HDR.unpack(_recv_exact(sock, 4))
    if hlen > 1 << 20:
        raise ConnectionError(f"header length {hlen} exceeds 1 MiB cap")
    header = json.loads(_recv_exact(sock, hlen).decode())
    payload = b""
    if "h" in header and "w" in header:
        dt = _DTYPES.get(header.get("dtype", "f32"))
        if dt is None:
            raise ConnectionError(f"unknown dtype {header.get('dtype')!r}")
        payload = _recv_exact(
            sock, int(header["h"]) * int(header["w"]) * dt.itemsize)
    return header, payload


def _parse_address(address: str):
    """``host:port`` -> TCP, anything else -> Unix-socket path."""
    if ":" in address and os.path.sep not in address:
        host, port = address.rsplit(":", 1)
        return socket.AF_INET, (host or "127.0.0.1", int(port))
    return socket.AF_UNIX, address


class _Conn:
    """One client connection; ``send`` is locked because the completer and
    the reader (error replies) write concurrently."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._lock = threading.Lock()

    def send(self, obj: dict) -> None:
        data = json.dumps(obj).encode()
        try:
            with self._lock:
                self.sock.sendall(_HDR.pack(len(data)) + data)
        except OSError:
            pass  # client went away; its pending results are dropped

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


@dataclass
class _Entry:
    conn: _Conn
    rid: Any
    frame: np.ndarray  # (h, w), u16 or f32
    bbx: np.ndarray    # (5,) f32
    t_in: float = field(default_factory=time.monotonic)


def _to_host(dev):
    """Queue the copy of a dispatch's result to the host behind it: on a
    CUDA tensor a non-blocking copy into pinned memory and a CUDA event
    recorded after it, so the completer waits for this dispatch alone;
    anything else as it is, with no event."""
    if isinstance(dev, torch.Tensor) and dev.is_cuda:
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done
    return dev, None


class Server:
    """Micro-batching inference server over a live predictor.

    Args:
      predictor: ``serving.Predictor``, or anything with
        ``_dispatch(frames[b,h,w,1], bbxs[b,5])`` (a tensor, on its device,
        or an array, with at least ``b`` rows), ``max_batch`` and
        ``camera``.
      address: Unix-socket path, or ``host:port`` for TCP.
      window_ms: after the first request of a batch arrives, wait at most
        this long for more before dispatching (the classic latency/
        throughput knob; 0 dispatches every request alone).
      frame_hw: accepted raw frame size; defaults to the predictor
        camera's sensor size (requests of any other size get an error
        response, since cross-client batching needs one static shape).
      max_queue: bound on queued-but-undispatched requests; a request
        arriving with the queue full is SHED with an immediate
        ``{"error": "overloaded"}`` response instead of growing host
        memory without bound.  Defaults to ``8 * max_batch`` (eight full
        dispatches of headroom — deep enough to ride out a batching
        window, shallow enough that queueing delay stays bounded by a few
        device steps).  0 disables the bound.
    """

    def __init__(self, predictor, address: str, window_ms: float = 2.0,
                 frame_hw: Optional[Tuple[int, int]] = None,
                 max_queue: Optional[int] = None):
        self.predictor = predictor
        self.window_s = window_ms / 1e3
        if frame_hw is None:
            cam = predictor.camera
            frame_hw = (getattr(predictor, "frame_hw", None)
                        or (int(cam.h), int(cam.w)))
        self.frame_hw = tuple(int(v) for v in frame_hw)
        # a predictor that takes uint16 frames keeps integer depth in native
        # width to halve the host-to-device bytes; others get u16 requests
        # cast on the host
        self._u16_ok = getattr(predictor, "accepts_u16", False)
        self._family, addr = _parse_address(address)
        if self._family == socket.AF_UNIX and os.path.exists(addr):
            os.unlink(addr)  # stale socket from a previous run
        self._listener = socket.socket(self._family, socket.SOCK_STREAM)
        if self._family == socket.AF_INET:
            self._listener.setsockopt(
                socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind(addr)
        self._listener.listen(64)
        # accept() wakes every 0.1 s to see a shutdown: closing the socket
        # does not wake a thread blocked in it on every platform
        self._listener.settimeout(0.1)
        self.address = addr if self._family == socket.AF_UNIX else \
            "%s:%d" % self._listener.getsockname()[:2]

        if max_queue is None:
            max_queue = 8 * int(predictor.max_batch)
        self.max_queue = int(max_queue)
        self._q: "queue.Queue[_Entry]" = queue.Queue(maxsize=self.max_queue)
        self._done: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._t0 = time.monotonic()
        self._stats_lock = threading.Lock()
        self._requests = self._responses = self._batches = 0
        self._batched_frames = self._errors = self._sheds = 0
        self._lat_ms = collections.deque(maxlen=10000)
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True),
            threading.Thread(target=self._batch_loop, daemon=True),
            threading.Thread(target=self._complete_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # -- client-facing threads ------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # listener closed by shutdown()
            sock.settimeout(None)
            conn = _Conn(sock)
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._client_loop, args=(conn,),
                             daemon=True).start()

    def _client_loop(self, conn: _Conn) -> None:
        try:
            while not self._stop.is_set():
                header, payload = _read_msg(conn.sock)
                if "cmd" in header:
                    self._control(conn, header)
                    continue
                rid = header.get("id")
                hw = (int(header["h"]), int(header["w"]))
                if hw != self.frame_hw:
                    with self._stats_lock:
                        self._errors += 1
                    conn.send({"id": rid, "error":
                               f"frame {hw} != served {self.frame_hw}"})
                    continue
                bbx = np.asarray(header["bbx"], np.float32)
                if bbx.shape != (5,):
                    with self._stats_lock:
                        self._errors += 1
                    conn.send({"id": rid,
                               "error": "bbx must be 5 floats"})
                    continue
                dt = _DTYPES[header.get("dtype", "f32")]
                frame = np.frombuffer(payload, dt).reshape(hw)
                with self._stats_lock:
                    self._requests += 1
                try:
                    self._q.put_nowait(_Entry(conn, rid, frame, bbx))
                except queue.Full:
                    # load shedding: never let a flooding client grow host
                    # memory/tail latency unboundedly — reply immediately
                    # so it can back off (the connection stays usable)
                    with self._stats_lock:
                        self._sheds += 1
                    conn.send({"id": rid, "error": "overloaded"})
        except (ConnectionError, OSError, ValueError, KeyError,
                json.JSONDecodeError):
            pass  # framing broken or peer gone: drop the connection
        finally:
            conn.close()
            with self._conns_lock:
                self._conns.discard(conn)

    def _control(self, conn: _Conn, header: dict) -> None:
        cmd = header["cmd"]
        if cmd == "ping":
            conn.send({"id": header.get("id"), "ok": True})
        elif cmd == "stats":
            conn.send({"id": header.get("id"), "stats": self.stats()})
        else:
            conn.send({"id": header.get("id"),
                       "error": f"unknown cmd {cmd!r}"})

    # -- device-facing threads ------------------------------------------

    def _batch_loop(self) -> None:
        max_b = self.predictor.max_batch
        while True:
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set():
                    self._done.put(None)
                    return
                continue
            entries = [first]
            deadline = time.monotonic() + self.window_s
            while len(entries) < max_b:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    entries.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            try:
                if self._u16_ok and all(e.frame.dtype == np.uint16
                                        for e in entries):
                    frames = np.stack([e.frame for e in entries])
                else:
                    frames = np.stack([e.frame.astype(np.float32)
                                       for e in entries])
                bbxs = np.stack([e.bbx for e in entries])
                dev = _to_host(self.predictor._dispatch(frames[..., None],
                                                        bbxs))
            except Exception as exc:  # device failure: report, keep serving
                for e in entries:
                    e.conn.send({"id": e.rid, "error": repr(exc)})
                with self._stats_lock:
                    self._errors += len(entries)
                continue
            with self._stats_lock:
                self._batches += 1
                self._batched_frames += len(entries)
            self._done.put((dev, entries))

    def _complete_loop(self) -> None:
        while True:
            item = self._done.get()
            if item is None:
                return
            (host, done), entries = item
            try:
                if done is not None:
                    done.synchronize()
                xyz = (host.numpy() if isinstance(host, torch.Tensor)
                       else np.asarray(host))
            except Exception as exc:
                for e in entries:
                    e.conn.send({"id": e.rid, "error": repr(exc)})
                with self._stats_lock:
                    self._errors += len(entries)
                continue
            now = time.monotonic()
            # count BEFORE replying: a client that got its answer must see
            # it reflected in an immediately-following stats query
            with self._stats_lock:
                self._responses += len(entries)
                for e in entries:
                    self._lat_ms.append((now - e.t_in) * 1e3)
            for i, e in enumerate(entries):
                e.conn.send({"id": e.rid,
                             "xyz": np.asarray(xyz[i], np.float64).tolist()})

    # -- lifecycle / introspection --------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._lat_ms)
            q = (lambda p: lat[min(len(lat) - 1,
                                   int(p * len(lat)))]) if lat else \
                (lambda p: 0.0)
            return {
                "requests": self._requests,
                "responses": self._responses,
                "errors": self._errors,
                "sheds": self._sheds,
                "queue_depth": self._q.qsize(),
                "max_queue": self.max_queue,
                "batches": self._batches,
                "mean_batch": (self._batched_frames / self._batches
                               if self._batches else 0.0),
                "p50_ms": round(q(0.50), 3),
                "p99_ms": round(q(0.99), 3),
                "uptime_s": round(time.monotonic() - self._t0, 1),
                "max_batch": self.predictor.max_batch,
                "frame_hw": list(self.frame_hw),
            }

    def shutdown(self) -> None:
        """Stop accepting, drain in-flight work, close every connection."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._listener.close()
        for t in self._threads:
            t.join(timeout=30)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        if self._family == socket.AF_UNIX and os.path.exists(self.address):
            os.unlink(self.address)

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


class Client:
    """Minimal synchronous/pipelined client for :class:`Server`.

    ``submit``/``recv`` expose the pipelined form (keep several requests in
    flight so the server can micro-batch them); ``predict`` is the one-shot
    convenience.  Responses come back in submission order on a given
    connection (the server batches FIFO and the completer replies in batch
    order).
    """

    def __init__(self, address: str):
        family, addr = _parse_address(address)
        self.sock = socket.socket(family, socket.SOCK_STREAM)
        self.sock.connect(addr)
        self._next_id = 0

    def submit(self, frame: np.ndarray, bbx, rid=None) -> Any:
        frame = np.ascontiguousarray(frame)
        if frame.dtype == np.uint16:
            dtype = "u16"
        else:
            frame = frame.astype("<f4", copy=False)
            dtype = "f32"
        if rid is None:
            rid, self._next_id = self._next_id, self._next_id + 1
        header = json.dumps({
            "id": rid, "h": int(frame.shape[0]), "w": int(frame.shape[1]),
            "dtype": dtype, "bbx": np.asarray(bbx, float).tolist(),
        }).encode()
        self.sock.sendall(_HDR.pack(len(header)) + header
                          + frame.tobytes())
        return rid

    def recv(self) -> dict:
        (hlen,) = _HDR.unpack(_recv_exact(self.sock, 4))
        return json.loads(_recv_exact(self.sock, hlen).decode())

    def predict(self, frame: np.ndarray, bbx) -> np.ndarray:
        rid = self.submit(frame, bbx)
        resp = self.recv()
        if "error" in resp:
            raise RuntimeError(f"server error: {resp['error']}")
        assert resp["id"] == rid, (resp["id"], rid)
        return np.asarray(resp["xyz"], np.float32)

    def predict_batch(self, frames: np.ndarray, bbxs: np.ndarray
                      ) -> np.ndarray:
        """Submit every frame before reading any result, so the server can
        batch them into as few device dispatches as possible."""
        rids = [self.submit(f, b) for f, b in zip(frames, bbxs)]
        by_id = {}
        for _ in rids:
            resp = self.recv()
            if "error" in resp:
                raise RuntimeError(f"server error: {resp['error']}")
            by_id[resp["id"]] = resp["xyz"]
        return np.asarray([by_id[r] for r in rids], np.float32)

    def _cmd(self, cmd: str) -> dict:
        data = json.dumps({"cmd": cmd}).encode()
        self.sock.sendall(_HDR.pack(len(data)) + data)
        return self.recv()

    def ping(self) -> bool:
        return bool(self._cmd("ping").get("ok"))

    def stats(self) -> dict:
        return self._cmd("stats")["stats"]

    def close(self) -> None:
        self.sock.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
