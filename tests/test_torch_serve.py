"""The port's serving daemon (``densereg_torch.serve``) on the CPU: the
wire protocol, cross-client micro-batching, buckets, errors, TCP,
concurrent clients and load shedding (the cases of the JAX package's
``tests/test_serve.py`` that apply), against the port's own ``Predictor``
(atol 1e-5, as there) and against the JAX ``Predictor`` on the same
weights within the decode's 2e-4 normalized bound (0.02 mm).
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from densereg_tpu import config as jconfig  # noqa: E402
from densereg_tpu.serving import Predictor as JPredictor  # noqa: E402

from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch.models import init_variables  # noqa: E402
from densereg_torch.serve import Client, Server, _to_host  # noqa: E402

from test_torch_serving import _hand_frames  # noqa: E402

ICVL = CameraConfig(fx=241.42, fy=241.42, cx=160, cy=120, w=320, h=240)
SHAPE = dict(num_stack=1, num_fea=8, num_joint=4, input_hw=(32, 32))
NET = NetConfig(**SHAPE)
BBX = np.array([60, 80, 200, 260, 600], np.float32)
XYZ_ATOL_MM = 0.02


def _frames(rng, n):
    # integer-valued mm depth: exactly representable in both u16 and f32,
    # so the two wire dtypes must give identical results
    return rng.integers(300, 500, (n, 240, 320)).astype(np.float32)


@pytest.fixture(scope="module")
def variables():
    return init_variables(NET, seed=5)


@pytest.fixture(scope="module")
def pred(variables):
    return Predictor(variables, NET, ICVL, max_batch=4, device="cpu")


@pytest.fixture
def server(pred, tmp_path):
    with Server(pred, str(tmp_path / "s.sock"), window_ms=50) as s:
        yield s


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_roundtrip_matches_direct(pred, server, rng):
    frames = _frames(rng, 3)
    want = pred(frames, np.tile(BBX, (3, 1)))
    with Client(server.address) as c:
        assert c.ping()
        got = np.stack([c.predict(f, BBX) for f in frames])
        st = c.stats()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert st["responses"] == 3 and st["errors"] == 0
    assert st["frame_hw"] == [240, 320] and st["max_batch"] == 4


def test_pipelined_requests_are_microbatched(pred, tmp_path, rng):
    """8 requests submitted before any result is read are coalesced into
    fewer dispatches than requests."""
    frames = _frames(rng, 8)
    bbxs = np.tile(BBX, (8, 1))
    with Server(pred, str(tmp_path / "b.sock"), window_ms=300) as s:
        with Client(s.address) as c:
            got = c.predict_batch(frames, bbxs)
            st = c.stats()
    np.testing.assert_allclose(got, pred(frames, bbxs), rtol=0, atol=1e-5)
    assert st["responses"] == 8
    assert st["batches"] < 8 and st["mean_batch"] > 1.5, st


def test_bucketed_predictor_through_daemon(variables, tmp_path, rng):
    """Lone requests dispatch at the 1-bucket, and the answers match the
    direct predictor's lone frames (a bucket of another size may run its
    convolutions by another algorithm)."""
    p = Predictor(variables, NET, ICVL, max_batch=4, batch_buckets=(1, 2),
                  device="cpu")
    frames = _frames(rng, 3)
    want = np.concatenate([p(f[None], BBX[None]) for f in frames])
    rows = []
    dispatch = p._dispatch
    p._dispatch = lambda f, b: rows.append(len(f)) or dispatch(f, b)
    with Server(p, str(tmp_path / "bk.sock"), window_ms=0) as s:
        with Client(s.address) as c:
            got = np.stack([c.predict(f, BBX) for f in frames])
            st = c.stats()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert st["batches"] == 3 and st["mean_batch"] == 1.0, st
    assert rows == [1, 1, 1]


def test_semantic_error_keeps_connection_usable(server, rng):
    with Client(server.address) as c:
        c.submit(np.full((16, 16), 400, np.float32), BBX)
        resp = c.recv()
        assert "error" in resp and "16, 16" in resp["error"]
        xyz = c.predict(_frames(rng, 1)[0], BBX)
        assert xyz.shape == (12,) and np.isfinite(xyz).all()
        assert c._cmd("nope")["error"] == "unknown cmd 'nope'"
        assert c.stats()["errors"] == 1


def test_u16_request_matches_f32(server, rng):
    f = _frames(rng, 1)[0]
    with Client(server.address) as c:
        np.testing.assert_array_equal(c.predict(f.astype(np.uint16), BBX),
                                      c.predict(f, BBX))


def test_tcp_transport(pred, rng):
    with Server(pred, "127.0.0.1:0", window_ms=10) as s:
        assert ":" in s.address
        with Client(s.address) as c:
            xyz = c.predict(_frames(rng, 1)[0], BBX)
    assert xyz.shape == (12,) and np.isfinite(xyz).all()


def test_concurrent_clients_all_answered(pred, tmp_path, rng):
    frames = _frames(rng, 6)
    want = pred(frames, np.tile(BBX, (6, 1)))
    results, errs = {}, []

    def one(i):
        try:
            with Client(srv.address) as c:
                results[i] = c.predict(frames[i], BBX)
        except Exception as e:  # surfaced below; keep the join running
            errs.append((i, e))

    with Server(pred, str(tmp_path / "c.sock"), window_ms=100) as srv:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        st = srv.stats()
    assert not errs, errs
    for i in range(6):
        np.testing.assert_allclose(results[i], want[i], rtol=0, atol=1e-5)
    assert st["responses"] == 6 and st["errors"] == 0


class _SlowPredictor:
    """A predictor that drains slower than a flooding client, so that the
    shedding does not depend on the host's speed."""

    def __init__(self, inner, delay_s=0.1):
        self._inner, self._delay = inner, delay_s
        self.max_batch = inner.max_batch
        self.camera = inner.camera
        self.accepts_u16 = inner.accepts_u16

    def _dispatch(self, frames, bbxs):
        time.sleep(self._delay)
        return self._inner._dispatch(frames, bbxs)


def test_backpressure_sheds_flood(pred, tmp_path, rng):
    """Excess requests get an immediate ``overloaded`` error, every accepted
    request is answered and the connection stays usable."""
    n = 64
    frame = _frames(rng, 1)[0]
    with Server(_SlowPredictor(pred), str(tmp_path / "f.sock"),
                window_ms=50, max_queue=3) as s:
        with Client(s.address) as c:
            for i in range(n):
                c.submit(frame, BBX, rid=i)
            ok = shed = 0
            for _ in range(n):
                resp = c.recv()
                if resp.get("error") == "overloaded":
                    shed += 1
                else:
                    assert len(resp["xyz"]) == 12
                    ok += 1
            st = c.stats()
            assert np.isfinite(c.predict(frame, BBX)).all()
    assert ok + shed == n and shed > 0
    assert st["sheds"] == shed
    assert st["max_queue"] == 3 and st["queue_depth"] <= 3
    assert st["responses"] == ok


class _FailingPredictor(_SlowPredictor):
    def _dispatch(self, frames, bbxs):
        raise RuntimeError("device lost")


def test_dispatch_failure_is_an_error_reply(pred, tmp_path, rng):
    """A failing dispatch answers its requests with the error and keeps
    serving; ``stats()`` counts them as errors, not responses."""
    with Server(_FailingPredictor(pred), str(tmp_path / "x.sock"),
                window_ms=0) as s:
        with Client(s.address) as c:
            c.submit(_frames(rng, 1)[0], BBX)
            assert "device lost" in c.recv()["error"]
            assert c.ping()
            st = c.stats()
    assert st["errors"] == 1 and st["responses"] == 0


def test_cpu_results_need_no_event():
    t = torch.arange(6.0).reshape(2, 3)
    host, done = _to_host(t)
    assert host is t and done is None


def test_daemon_matches_jax_predictor(variables, pred, tmp_path):
    """Hand-like uint16 frames through the daemon, against the JAX
    ``Predictor`` on the same weights. A joint further apart than the
    decode's bound is named, with the frame, so that a flip of a near-tied
    top-k candidate shows as what it is."""
    frames, bbxs = _hand_frames(np.random.default_rng(2), 6)
    frames = frames.astype(np.uint16)
    theirs = JPredictor(variables, jconfig.NetConfig(**SHAPE),
                        jconfig.CameraConfig(*ICVL), max_batch=4)
    want = theirs(frames, bbxs)
    with Server(pred, str(tmp_path / "j.sock"), window_ms=50) as s:
        with Client(s.address) as c:
            got = c.predict_batch(frames, bbxs)
            st = c.stats()
    assert st["errors"] == 0 and st["responses"] == 6
    err = np.abs(got - want).reshape(6, -1, 3).max(axis=-1)
    off = [(int(f), int(j), float(err[f, j]))
           for f, j in zip(*np.nonzero(err > XYZ_ATOL_MM))]
    assert not off, f"(frame, joint, mm) past the decode bound: {off}"
