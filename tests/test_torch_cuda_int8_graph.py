"""The int8 serving forward replayed as a CUDA graph
(``models.int8_graph.Int8ForwardGraph``, reached from
``serving.ServingModule``) against the same forward run eagerly, on the
card, at the paper's width: the calibrated and the dynamic ``um_v1_lite``
at MSRA's J = 21 and the calibrated ``um_v1``, at bucket 256 and at a
padded bucket of 3.

The replay launches the eager forward's kernels with the same arguments,
so every head is bit-equal to the eager one; a double-buffered request
equals its chunks run eagerly (no head is overwritten before its decode);
a ``calibrate()`` after a capture leads to a new capture; ``heads()``
hands out copies; and a replay runs, by a device trace's kernel records,
the eager forward's K3, DW and Q kernels, while the counters of calls made
on the host move for the eager call and the capture and stay put for a
replay.

These tests need an NVIDIA GPU with the CUDA toolkit and skip elsewhere.
They import no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_int8_graph.py -q
"""

import copy
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from chip_smoke import ICVL, hand_frames  # noqa: E402
from densereg_torch import NetConfig, Predictor  # noqa: E402
from densereg_torch.decode import decode_poses  # noqa: E402
from densereg_torch.models import calibrate, init_variables, layers  # noqa: E402
from densereg_torch.ops import int8_dwconv, int8_gemm, int8_quantize  # noqa: E402

LITE21 = NetConfig(net_module="um_v1_lite", num_joint=21)
NETS = {"lite21-calibrated": (LITE21, True),
        "lite21-dynamic": (LITE21, False),
        "um_v1-calibrated": (NetConfig(num_joint=14), True)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU form")
    return torch.device("cuda")


def _frames(seed: int, b: int):
    return hand_frames(np.random.default_rng(seed), b)


def _predictor(cfg, calibrated: bool, device, **kw):
    return Predictor(init_variables(cfg, seed=0), cfg, ICVL, max_batch=256,
                     batch_buckets=(3,), quantize=True, device=device,
                     calibration=_frames(100, 64) if calibrated else None,
                     **kw)


def _normed(pred, frames, bbxs):
    """The net's input, crops and centers of mass of a request."""
    with torch.inference_mode():
        return pred.module.normed(pred._to_device(frames[..., None]),
                                  pred._to_device(bbxs))


def _eager_xyz(pred, frames, bbxs, bucket: int) -> np.ndarray:
    """One chunk padded to ``bucket`` as ``HostLoop`` pads it, through the
    net called eagerly, then the serving decode."""
    b = len(frames)
    pad = lambda a: np.concatenate([a, np.repeat(a[-1:], bucket - b, 0)])
    normed, cfgs, coms = _normed(pred, pad(frames), pad(bbxs))
    with torch.inference_mode():
        outs = pred.net(normed)
        return decode_poses(*pred.module._subsample(outs, normed), cfgs,
                            coms, pred.ecfg)["xyz"][:b].cpu().numpy()


def _moved(before: dict) -> dict:
    return {k: layers.int8_counts[k] - before[k] for k in before}


@pytest.mark.cuda
@pytest.mark.parametrize("bucket", [256, 3])
@pytest.mark.parametrize("net", sorted(NETS))
def test_graphed_forward_is_bit_equal_to_eager(cuda, net, bucket):
    """Three batches through the serving module's net (an eager call that
    captures, then two replays), each against the net called eagerly."""
    cfg, calibrated = NETS[net]
    pred = _predictor(cfg, calibrated, cuda)
    batches = [_normed(pred, *_frames(seed, bucket))[0] for seed in (1, 2, 3)]
    before = dict(layers.int8_counts)
    got = []
    with torch.inference_mode():
        want = [pred.net(x) for x in batches]
        for x in batches:
            outs = pred.module._net(x)
            got.append({k: [t.clone() for t in v] for k, v in outs.items()})
    moved = _moved(before)
    assert (moved["graph_captures"], moved["graph_replays"]) == (1, 2)
    for g, w in zip(got, want):
        for key in ("hm", "hm3", "um"):
            assert len(g[key]) == len(w[key]) == cfg.num_stack
            for a, b in zip(g[key], w[key]):
                assert a.shape == b.shape and torch.equal(a, b), key


@pytest.mark.cuda
def test_double_buffered_request_equals_eager_chunks(cuda):
    """A 1,024-frame request runs four replays of bucket 256, each chunk
    enqueued before the last one's fetch, and equals its chunks run
    eagerly; a 2-frame request replays bucket 3."""
    pred = _predictor(LITE21, True, cuda)
    pred.warmup(with_u16=False)             # captures both buckets
    frames, bbxs = _frames(7, 1024)
    before = dict(layers.int8_counts)
    got = pred(frames, bbxs)
    small = pred(frames[:2], bbxs[:2])
    moved = _moved(before)
    assert (moved["graph_captures"], moved["graph_replays"]) == (0, 5)
    want = np.concatenate([_eager_xyz(pred, frames[i:i + 256],
                                      bbxs[i:i + 256], 256)
                           for i in range(0, 1024, 256)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(small, _eager_xyz(pred, frames[:2],
                                                    bbxs[:2], 3))
    # a copy of a module that holds graphs (an export to another
    # platform, a mesh's replica) starts with none, on its own net
    twin = copy.deepcopy(pred.module)
    assert twin.graph.net is twin.net and not twin.graph._graphs


@pytest.mark.cuda
def test_calibrate_after_a_capture_captures_again(cuda):
    """A running max recorded after the capture replaces the activation
    maxima: the next dispatch runs eagerly and captures again, and the
    answers equal those of a fresh predictor calibrated alike."""
    frames, bbxs = _frames(12, 256)
    more = _frames(11, 64)
    pred = _predictor(LITE21, True, cuda)
    pred(frames, bbxs)
    first = pred(frames, bbxs)
    old = pred.module.graph._stamp()
    calibrate(pred.net, [_normed(pred, *more)[0]])
    assert pred.module.graph._stamp() != old
    before = dict(layers.int8_counts)
    got = [pred(frames, bbxs) for _ in range(2)]
    moved = _moved(before)
    assert (moved["graph_captures"], moved["graph_replays"]) == (1, 1)
    fresh = _predictor(LITE21, True, cuda)
    calibrate(fresh.net, [_normed(fresh, *more)[0]])
    want = fresh(frames, bbxs)
    for g in got:
        np.testing.assert_array_equal(g, want)
    assert np.isfinite(first).all()


@pytest.mark.cuda
def test_heads_of_two_calls_are_independent(cuda):
    """``heads()`` of a replay copies the graph's heads, stride for
    stride: a second call leaves the first call's heads as they were, and
    each equals the eager net's."""
    pred = _predictor(LITE21, True, cuda)
    pred.warmup(with_u16=False)
    a, b = _frames(21, 256), _frames(22, 256)
    dev = lambda f, bb: (pred._to_device(f[..., None]), pred._to_device(bb))
    before = dict(layers.int8_counts)
    ha = pred._heads(*dev(*a))
    kept = [t.clone() for t in ha[:3]]
    hb = pred._heads(*dev(*b))
    assert _moved(before)["graph_replays"] == 2
    normed = _normed(pred, *a)[0]
    with torch.inference_mode():
        eager = pred.module._subsample(pred.net(normed), normed)
    for x, k, y, e in zip(ha[:3], kept, hb[:3], eager[:3]):
        assert torch.equal(x, k) and torch.equal(x, e)
        assert x.stride() == e.stride() and not torch.equal(x, y)


# the int8 kernels' ``__global__`` symbols in ``csrc/``, Q's by path
SYMBOLS = {"K3": "k3_kernel", "DW": "dw_kernel", "Q.flat": "quantize_flat",
           "Q.elements": "quantize_elements"}


def _host_calls() -> dict:
    """The counters of calls made on the host: ``int8_counts`` and the
    K3, DW and Q wrappers' launches, Q's by path."""
    q = int8_quantize.int8_quantize.launches_by_path
    return {**layers.int8_counts,
            "K3": int8_gemm.int8_gemm_requant.launches,
            "DW": int8_dwconv.int8_dwconv_requant.launches,
            **{f"Q.{p}": n for p, n in q.items()}}


def _since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _host_calls().items()
            if n != before[k]}


def _run(fn):
    """``fn()`` under ``torch.profiler``: how the host counters moved, and
    how many kernel records of each of :data:`SYMBOLS` the card ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = _host_calls()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return _since(before), {
        k: sum(bool(re.search(rf"\b{sym}\b", n)) for n in names)
        for k, sym in SYMBOLS.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("net", ["lite21-calibrated", "lite21-dynamic"])
def test_replay_runs_the_eager_forwards_kernels(cuda, net):
    """The eager forward, the capturing call (the eager call, then the
    capture) and a replay. On the host the capturing call moves every
    counter twice as far as the eager forward, and a replay none but
    ``graph_replays``; under the profiler the replay runs the eager
    forward's K3, DW and Q kernels, one record a host call of the eager
    forward. At J = 21 the lite forward is 105 K3 calls, 41 DW and 69
    quantize steps when calibrated."""
    cfg, calibrated = NETS[net]
    pred = _predictor(cfg, calibrated, cuda)
    x = _normed(pred, *_frames(31, 256))[0]

    eager, eager_ran = _run(lambda: pred.net(x))
    before = _host_calls()
    with torch.inference_mode():
        pred.module._net(x)
    capture = _since(before)
    replay, replay_ran = _run(lambda: pred.module._net(x))
    assert capture == {**{k: 2 * n for k, n in eager.items()},
                       "graph_captures": 1}
    assert replay == {"graph_replays": 1}
    assert eager_ran == replay_ran == {k: eager.get(k, 0) for k in SYMBOLS}
    assert (eager["k3_dense"] + eager.get("k3_implicit", 0), eager["K3"],
            eager["dw"], eager["DW"]) == (105, 105, 41, 41)
    assert (eager["quantize"] == eager["quantize_kernel"]
            == eager.get("Q.flat", 0) + eager.get("Q.elements", 0))
    if calibrated:
        assert eager["quantize"] == 69 and "dynamic" not in eager
    else:
        assert eager["dynamic"] > 0
