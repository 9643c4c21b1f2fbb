"""The port's calibrated int8 nets against the benchmark's plain int8
references, which import nothing of the port: ``um_v1_lite`` at MSRA15's
21 joints (``benchmark/reference/lite.py``) and the paper's ``um_v1`` at
ICVL's 16 joints (``benchmark/reference/int8_dense.py``), each on the CPU
at a small size (2 stacks, 16 features, 32x32 crops), on the reference's
seeded weights and frames.

Served through ``Predictor(quantize=True, calibration=...)``, the port
gives the reference's int8 weights and scales bit for bit, every layer's
calibrated activation maximum equal, the heads equal (both sum exactly and
round each float32 step once, in the same order) and the joints within
1e-4 mm (the same decode arithmetic); its int8 counters
(``models.layers.int8_counts``) give the steps the architecture gives,
none of them dynamic and none a kernel launch (on the CPU); and under a
CPU profiler each standalone quantize step leaves a
``densereg.int8.quantize`` span inside ``densereg.net``.
For ``um_v1`` the port's K3 calls, seen as their custom ops under a CPU
profiler, come in the order and of the kinds that the benchmark's
yardstick (``benchmark/counting_int8_dense.py``) pairs with a replay's
kernel records."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark import frames  # noqa: E402
from benchmark.reference import int8_dense, lite, lite_weights  # noqa: E402
from benchmark.reference import serving as ref_serving  # noqa: E402
from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch.models import layers  # noqa: E402

# the benchmark's own modules import one another as top-level modules
BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)

import counting_int8_dense  # noqa: E402
import weights as bench_weights  # noqa: E402

CAMERA = dict(fx=241.42, fy=241.42, cx=160.0, cy=120.0, w=320.0, h=240.0)
SMALL = dict(num_stack=2, num_fea=16, kernel_size=3, compute_dtype="float32",
             bn_epsilon=1e-3, input_size=32, camera=CAMERA)
# s2/f16 at 32x32 (hourglass depth 2): 29 residuals, so 29 bottleneck
# k x k convolutions, the 7x7/2 stem, and 80 1x1 convolutions; 29
# residual sums, 4 hourglass sums and 20 convolutions of a float input
# quantized on their own. The lite net runs its 29 bottleneck convolutions
# depthwise, um_v1 on K3's implicit GEMM.
NETS = {
    "um_v1_lite": dict(
        cfg=dict(SMALL, net_module="um_v1_lite", num_joint=21),
        weights=lite_weights.serving_weights,
        calibrate=lite.calibrate, int8_forward=lite.int8_forward,
        form=lite.Int8Form,
        steps={"k3_dense": 80, "k3_implicit": 1, "dw": 29, "quantize": 53}),
    "um_v1": dict(
        cfg=dict(SMALL, net_module="um_v1", num_joint=16),
        weights=bench_weights.serving_weights,
        calibrate=int8_dense.calibrate, int8_forward=int8_dense.int8_forward,
        form=int8_dense.Int8Form,
        steps={"k3_dense": 80, "k3_implicit": 30, "dw": 0, "quantize": 53}),
}


@pytest.fixture(scope="module", params=sorted(NETS))
def served(request):
    """The port's calibrated predictor and the reference's int8 net on the
    same seeded weights and calibration frames, and 12 served frames."""
    net = NETS[request.param]
    cfg = net["cfg"]
    j = cfg["num_joint"]
    gen = torch.Generator().manual_seed(17)
    depth, _, boxes = frames.render(12, CAMERA, j, gen, "cpu")
    cal_depth, _, cal_boxes = frames.render(8, CAMERA, j, gen, "cpu")
    cam = torch.tensor([CAMERA[k] for k in ("fx", "fy", "cx", "cy", "w",
                                            "h")])
    crops = ref_serving.normed_crops(cfg, depth, boxes, cam)
    params, stats = net["weights"](cfg, gen, crops[:8])
    net_cfg = NetConfig(num_stack=2, num_fea=16, kernel_size=3, num_joint=j,
                        input_hw=(32, 32), net_module=cfg["net_module"])
    pred = Predictor(bench_weights.flax_tree(params, stats), net_cfg,
                     CameraConfig(**CAMERA), max_batch=4, quantize=True,
                     calibration=(cal_depth, cal_boxes), device="cpu")
    qparams = lite.quantize_weights(lite.fold(params, stats))
    amax = net["calibrate"](cfg, qparams, ref_serving.normed_crops(
        cfg, cal_depth, cal_boxes, cam))
    return dict(net, pred=pred, qparams=qparams, amax=amax, depth=depth,
                boxes=boxes, crops=crops, cam=cam)


def test_weights_and_scales_bit_equal(served):
    mods = dict(served["pred"].net.named_modules())
    checked = 0
    for key, want in served["qparams"].items():
        path, leaf = key.rsplit("/", 1)
        got = getattr(mods[path.replace("/", ".")], leaf)
        if leaf == "kernel_q":
            assert got.dtype == torch.int8
            got = got.permute(3, 2, 0, 1)          # HWIO -> OIHW
        assert torch.equal(got.float(), want), key
        checked += 1
    steps = served["steps"]
    assert checked == 3 * (steps["k3_dense"] + steps["k3_implicit"]
                           + steps["dw"])


def test_calibrated_maxima_equal(served):
    got = {}
    for name, mod in served["pred"].net.named_modules():
        for buf in ("amax", "out_amax"):
            v = getattr(mod, buf, None)
            if v is not None:
                got[f"{name.replace('.', '/')}/{buf}"] = v
    assert got.keys() == served["amax"].keys()
    for key, want in served["amax"].items():
        assert torch.equal(got[key], want), key


def test_heads_equal_and_joints_within_1e4_mm(served):
    with torch.inference_mode():
        got = served["pred"].net(served["crops"])
    cfg = served["cfg"]
    want = served["int8_forward"](served["qparams"], served["amax"])(
        cfg, served["crops"])
    for key in ("hm", "hm3", "um"):
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape
            assert torch.equal(g, w), key
    xyz = served["pred"](served["depth"], served["boxes"])
    ref = lite.predict(cfg, served["int8_forward"](served["qparams"],
                                                   served["amax"]),
                       served["depth"], served["boxes"], served["cam"], 4)
    assert xyz.shape == (12, 3 * cfg["num_joint"])
    assert np.abs(xyz - ref).max() <= 1e-4


def test_counters_give_the_architectures_steps(served):
    form = served["form"](served["qparams"], served["amax"])
    lite.forward(form, served["cfg"], served["crops"][:4])
    assert form.steps == served["steps"]
    before = dict(layers.int8_counts)
    with torch.inference_mode():
        served["pred"].net(served["crops"][:4])
    got = {k: layers.int8_counts[k] - before[k] for k in before}
    # the quantize kernel launches, and the forward is a CUDA graph, only
    # on the card
    assert got == dict(served["steps"], dynamic=0, quantize_kernel=0,
                       graph_captures=0, graph_replays=0)


def test_quantize_spans_under_a_cpu_profiler(served, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served["pred"](served["depth"][:4], served["boxes"][:4])
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    nets = [e for e in events if e["name"] == "densereg.net"]
    quant = [e for e in events if e["name"] == "densereg.int8.quantize"]
    assert len(nets) == 1
    assert len(quant) == served["steps"]["quantize"]
    a, b = nets[0]["ts"], nets[0]["ts"] + nets[0]["dur"]
    assert all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in quant)


@pytest.mark.parametrize("served", ["um_v1"], indirect=True)
def test_k3_calls_in_the_yardsticks_order(served, tmp_path):
    """The port's K3 entries in launch order, as their custom ops
    (``densereg::int8_gemm_requant``: the dense entry,
    ``densereg::int8_conv_requant``: the implicit GEMM), are the kinds of
    ``counting_int8_dense.calls`` in order: the pairing by which
    ``k3_implicit_roofline.batch_int8_dense`` tells a replay's records
    apart."""
    entries = {"densereg::int8_gemm_requant": "k3_dense",
               "densereg::int8_conv_requant": "k3_implicit"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            served["pred"].net(served["crops"][:4])
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        ops = sorted((e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("name") in entries),
                     key=lambda e: e["ts"])
    want = [c["kind"] for c in counting_int8_dense.calls(served["cfg"])]
    assert len(want) == 110
    assert [entries[e["name"]] for e in ops] == want
