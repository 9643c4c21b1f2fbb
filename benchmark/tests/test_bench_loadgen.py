"""The camera load generator against a stub daemon: the schedule, latency
timed from each request's due time (so a stall counts against the requests
it delays), sheds counted as failed and as misses, and answers that never
come counted as lost."""

import json
import socket
import struct
import threading
import time

import numpy as np

import loadgen

HDR = struct.Struct(">I")


class Stub:
    """Answers each request after ``delay`` s, in order, one connection a
    thread; sheds every request whose id ``k`` is in ``shed``, never
    answers those in ``drop``; stalls ``stall`` s before the first
    answer."""

    def __init__(self, delay=0.005, shed=(), drop=(), stall=0.0):
        self.delay, self.shed, self.drop, self.stall = delay, set(shed), \
            set(drop), stall
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(16)
        self.address = "127.0.0.1:%d" % self.sock.getsockname()[1]
        self.conns = []
        threading.Thread(target=self.accept, daemon=True).start()

    def accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.conns.append(conn)
            threading.Thread(target=self.serve, args=(conn,),
                             daemon=True).start()

    def serve(self, conn):
        first = True
        try:
            while True:
                (n,) = HDR.unpack(loadgen.recv_exact(conn, 4))
                hdr = json.loads(loadgen.recv_exact(conn, n))
                loadgen.recv_exact(conn, hdr["h"] * hdr["w"] * 2)
                if first:
                    time.sleep(self.stall)
                    first = False
                time.sleep(self.delay)
                k = hdr["id"][1]
                if k in self.drop:
                    continue
                body = ({"id": hdr["id"], "error": "overloaded"}
                        if k in self.shed else
                        {"id": hdr["id"], "xyz": [float(k)] * 6})
                data = json.dumps(body).encode()
                conn.sendall(HDR.pack(len(data)) + data)
        except (ConnectionError, OSError, struct.error):
            return

    def close(self):
        self.sock.close()
        for c in self.conns:
            c.close()


def frames(n=4):
    return (np.zeros((n, 6, 8), np.uint16),
            np.tile(np.asarray([[0, 0, 6, 8, 500]], np.float32), (n, 1)))


def test_schedule():
    plan = loadgen.schedule(3, 30.0, 1.0, 7, 5)
    assert [len(d) for d, _ in plan] == [30, 30, 30]
    for due, idx in plan:
        assert 0 <= due[0] < 1 / 30
        np.testing.assert_allclose(np.diff(due), 1 / 30)
        assert ((idx[1:] - idx[:-1]) % 5 == 1).all()
    again = loadgen.schedule(3, 30.0, 1.0, 7, 5)
    assert all((a[0] == b[0]).all() for a, b in zip(plan, again))


def test_latency_from_due_time_and_sheds():
    stub = Stub(delay=0.01, shed={3, 4})
    f, b = frames()
    try:
        totals, rec = loadgen.run(stub.address, 2, 20.0, 1.0, 1, f, b, 2,
                                  grace=2.0)
    finally:
        stub.close()
    assert totals["attempted"] == 40
    assert totals["errors"] == 4 and totals["lost"] == 0
    ok = rec["status"] == 0
    assert ok.sum() == 36
    assert (rec["latency_s"][ok] >= 0.01).all()
    assert np.median(rec["latency_s"][ok]) < 0.05
    # a shed is a miss: it sits above every answer in the percentiles
    assert totals["latency_p95_ms"] >= 1e3 * rec["latency_s"][ok].max()
    np.testing.assert_array_equal(rec["xyz"][ok][:, 0],
                                  np.tile(np.arange(20), 2)[ok])


def test_a_stall_counts_against_the_requests_it_delays():
    stub = Stub(delay=0.001, stall=0.3)
    f, b = frames()
    try:
        totals, rec = loadgen.run(stub.address, 1, 20.0, 1.0, 2, f, b, 2,
                                  grace=2.0)
    finally:
        stub.close()
    lat = rec["latency_s"]
    # the first answer waits 0.3 s; every request due meanwhile waits for
    # it too, each from its own due time
    assert lat[0] >= 0.3
    assert (lat[:5] > 0.1).all()
    assert lat[-1] < 0.1


def test_answers_that_never_come_are_lost():
    stub = Stub(drop={5})
    f, b = frames()
    try:
        totals, rec = loadgen.run(stub.address, 1, 20.0, 0.5, 3, f, b, 2,
                                  grace=0.5)
    finally:
        stub.close()
    assert totals["lost"] >= 1
    assert rec["status"][5] == loadgen.LOST
