"""The port's calibrated int8 ``um_v1_lite`` at MSRA15's 21 joints against
the benchmark's plain int8 reference (``benchmark/reference/lite.py``,
which imports nothing of the port), on the CPU at a small size (2 stacks,
16 features, 32x32 crops), on the reference's seeded weights and frames.

Served through ``Predictor(quantize=True, calibration=...)``, the port
gives the reference's int8 weights and scales bit for bit, every layer's
calibrated activation maximum equal, the heads equal (both sum exactly and
round each float32 step once, in the same order) and the joints within
1e-4 mm (the same decode arithmetic); its int8 counters
(``models.layers.int8_counts``) give the steps the architecture gives,
none of them dynamic; and under a CPU profiler each standalone quantize
step leaves a ``densereg.int8.quantize`` span inside ``densereg.net``."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark import frames  # noqa: E402
from benchmark.reference import lite, lite_weights  # noqa: E402
from benchmark.reference import serving as ref_serving  # noqa: E402
from densereg_torch import CameraConfig, NetConfig, Predictor  # noqa: E402
from densereg_torch.models import layers  # noqa: E402

CAMERA = dict(fx=241.42, fy=241.42, cx=160.0, cy=120.0, w=320.0, h=240.0)
CFG = dict(net_module="um_v1_lite", num_stack=2, num_fea=16, kernel_size=3,
           num_joint=21, input_size=32, compute_dtype="float32",
           bn_epsilon=1e-3, camera=CAMERA)
NET = NetConfig(num_stack=2, num_fea=16, kernel_size=3, num_joint=21,
                input_hw=(32, 32), net_module="um_v1_lite")
# s2/f16 at 32x32 (hourglass depth 2): 29 residuals, each with a depthwise
# convolution; 81 other convolutions, the 7x7/2 stem the one implicit
# GEMM; 29 residual sums, 4 hourglass sums and 20 convolutions of a float
# input quantized on their own
STEPS = {"k3_dense": 80, "k3_implicit": 1, "dw": 29, "quantize": 53}


def flax_tree(params, stats):
    """The reference's flat OIHW weights as the Flax-layout tree of numpy
    arrays (kernels HWIO) that the port's loaders take."""
    def nest(flat):
        tree = {}
        for path, t in flat.items():
            *parents, leaf = path.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            val = t.detach().float().numpy()
            node[leaf] = (val.transpose(2, 3, 1, 0) if leaf == "kernel"
                          else val).copy()
        return tree
    return {"params": nest(params), "batch_stats": nest(stats)}


@pytest.fixture(scope="module")
def served():
    """The port's calibrated predictor and the reference's int8 net on the
    same seeded weights and calibration frames, and 12 served frames."""
    gen = torch.Generator().manual_seed(17)
    depth, _, boxes = frames.render(12, CAMERA, 21, gen, "cpu")
    cal_depth, _, cal_boxes = frames.render(8, CAMERA, 21, gen, "cpu")
    cam = torch.tensor([CAMERA[k] for k in ("fx", "fy", "cx", "cy", "w",
                                            "h")])
    crops = ref_serving.normed_crops(CFG, depth, boxes, cam)
    params, stats = lite_weights.serving_weights(CFG, gen, crops[:8])
    pred = Predictor(flax_tree(params, stats), NET, CameraConfig(**CAMERA),
                     max_batch=4, quantize=True,
                     calibration=(cal_depth, cal_boxes), device="cpu")
    qparams = lite.quantize_weights(lite.fold(params, stats))
    amax = lite.calibrate(CFG, qparams, ref_serving.normed_crops(
        CFG, cal_depth, cal_boxes, cam))
    return dict(pred=pred, qparams=qparams, amax=amax, depth=depth,
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
    assert checked == 3 * (STEPS["k3_dense"] + STEPS["k3_implicit"]
                           + STEPS["dw"])


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
    want = lite.int8_forward(served["qparams"], served["amax"])(
        CFG, served["crops"])
    for key in ("hm", "hm3", "um"):
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape
            assert torch.equal(g, w), key
    xyz = served["pred"](served["depth"], served["boxes"])
    ref = lite.predict(CFG, lite.int8_forward(served["qparams"],
                                              served["amax"]),
                       served["depth"], served["boxes"], served["cam"], 4)
    assert xyz.shape == (12, 63)
    assert np.abs(xyz - ref).max() <= 1e-4


def test_counters_give_the_architectures_steps(served):
    form = lite.Int8Form(served["qparams"], served["amax"])
    lite.forward(form, CFG, served["crops"][:4])
    assert form.steps == STEPS
    before = dict(layers.int8_counts)
    with torch.inference_mode():
        served["pred"].net(served["crops"][:4])
    got = {k: layers.int8_counts[k] - before[k] for k in before}
    assert got == dict(STEPS, dynamic=0)


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
    assert len(quant) == STEPS["quantize"]
    a, b = nets[0]["ts"], nets[0]["ts"] + nets[0]["dur"]
    assert all(a <= e["ts"] and e["ts"] + e["dur"] <= b for e in quant)
