"""The standalone int8 quantize step (``ops/int8_quantize.py``, the custom
op ``densereg::int8_quantize``) on the CPU, where it runs its plain form.

The op's CPU form is the sequence the int8 forward ran before the kernel,
bit for bit: the scale ``max(amax, 1e-8) / 127`` by a tensor division, the
add where there is an addend, and ``ops.int8_layout.quantize`` with rows 16
bytes apart; at every width of the lite net at MSRA's 21 joints, in float32
and bfloat16, with and without the addend, and on the values where rounding
and clamping decide (exact half steps, +-inf, +-0, NaN, an amax of 0 or
NaN). The fake gives the real outputs' shapes, strides and pitch. A
calibrated lite forward, and its calibration, issue each standalone step as
one call of the op, and no round or clamp of their own. The kernel itself is held to this form
on the card (``tests/test_torch_cuda.py``).
"""

import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import cap_torch_threads  # noqa: E402

cap_torch_threads(torch)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from densereg_torch import NetConfig  # noqa: E402
from densereg_torch.models import (  # noqa: E402
    calibrate,
    fold_batch_norm,
    from_flax,
    init_variables,
    layers,
    quantize_weights,
)
from densereg_torch.models.bridge import seeded_depth  # noqa: E402
from densereg_torch.ops import int8_quantize as iq  # noqa: E402
from densereg_torch.ops.int8_layout import quantize  # noqa: E402

# the channel counts of the s2/f128 lite net's steps at J = 21: the stem's
# depth, the 64..512 sums and inputs, and the concatenations 105 (5J),
# 131 (f + 3), 170 (f + 2J) and 515 (512 + 3)
WIDTHS = (1, 64, 105, 128, 131, 170, 256, 512, 515)
DTYPES = (torch.float32, torch.bfloat16)


def sequence(a, b, amax):
    """The int8 forward's step as it ran before the op: ``(q, f, s)``."""
    s = torch.clamp_min(amax.float(), 1e-8)
    s = s / s.new_full((), 127.0)
    v = a if b is None else a + b
    return quantize(v, s, pitch16=True), (None if b is None else v), s


def same_bits(x, y) -> bool:
    """Equal shape, strides and bits (NaN equal to the same NaN)."""
    if x.shape != y.shape or x.stride() != y.stride() or x.dtype != y.dtype:
        return False
    if x.dtype.is_floating_point:
        view = {4: torch.int32, 2: torch.int16}[x.element_size()]
        return torch.equal(x.view(view), y.view(view))
    return torch.equal(x, y)


def assert_matches_sequence(a, b, amax):
    q, f, s = iq.int8_quantize(a, amax, b)
    q0, f0, s0 = sequence(a, b, amax)
    assert same_bits(q, q0)
    # the pitch: each row's storage is ceil(C / 16) * 16 bytes
    c = a.shape[-1]
    assert q.stride()[:-1] == tuple(
        -(-c // 16) * 16 * int(np.prod(a.shape[i + 1:-1], dtype=np.int64))
        for i in range(a.dim() - 1))
    assert same_bits(s, s0) and s.shape == ()
    if b is None:
        assert f is None
    else:
        assert same_bits(f, f0) and f.dtype == a.dtype


@pytest.mark.parametrize("with_b", (False, True), ids=("alone", "sum"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
@pytest.mark.parametrize("c", WIDTHS)
def test_cpu_form_is_the_sequence(c, dtype, with_b):
    g = torch.Generator().manual_seed(c)
    shape = (2, 3, 5, c)
    a = (torch.randn(shape, generator=g) * 3).to(dtype)
    b = (torch.randn(shape, generator=g) * 3).to(dtype) if with_b else None
    amax = torch.tensor(7.25)
    assert_matches_sequence(a, b, amax)


def edge_values(s: torch.Tensor) -> torch.Tensor:
    """Exact half steps of ``s`` and their neighbours, the clamp's edges,
    +-inf, +-0 and NaN, as float32."""
    steps = torch.arange(-130.5, 131.0, 1.0) * s
    near = torch.cat([torch.nextafter(steps, steps - 1), steps,
                      torch.nextafter(steps, steps + 1)])
    special = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0,
                            float("nan"), 1e-45, -1e-45, 3e38, -3e38])
    return torch.cat([near, special])


@pytest.mark.parametrize("amax", (7.25, 0.0, float("nan"), float("inf"),
                                  -1.0, 1e-9),
                         ids=("plain", "zero", "nan", "inf", "negative",
                              "below_floor"))
@pytest.mark.parametrize("dtype", DTYPES, ids=("f32", "bf16"))
def test_cpu_form_at_the_edges(amax, dtype):
    amax = torch.tensor(amax)
    s = sequence(torch.zeros(1), None, amax)[2]
    vals = edge_values(s if torch.isfinite(s) else torch.tensor(0.05))
    n = vals.numel() - vals.numel() % 48
    a = vals[:n].reshape(2, -1, 24).to(dtype)
    b = torch.flip(vals[:n], (0,)).reshape(2, -1, 24).to(dtype)
    for addend in (None, b, torch.zeros_like(a), -a):
        assert_matches_sequence(a, addend, amax)
        assert_matches_sequence(a[..., :17].contiguous(),
                                None if addend is None
                                else addend[..., :17].contiguous(), amax)


def test_amax_floor_and_nan():
    """An amax of 0 clamps to 1e-8 (as float32); a NaN amax stays NaN, and
    every value then quantizes to 0, as torch's conversion of a NaN."""
    a = torch.tensor([[1.0, -1.0, 0.0]])
    _, _, s = iq.int8_quantize(a, torch.tensor(0.0))
    assert s.item() == float(np.float32(1e-8) / np.float32(127))
    q, _, s = iq.int8_quantize(a, torch.tensor(float("nan")))
    assert torch.isnan(s)
    assert torch.equal(q, torch.zeros_like(q))


@pytest.mark.parametrize("with_b", (False, True), ids=("alone", "sum"))
@pytest.mark.parametrize("c", WIDTHS)
def test_fake_gives_the_real_layout(c, with_b):
    a = torch.randn(2, 4, 4, c)
    b = torch.randn(2, 4, 4, c) if with_b else None
    amax = torch.tensor(3.0)
    op = torch.ops.densereg.int8_quantize.default
    real = op(a, b, amax)
    with FakeTensorMode() as mode:
        fake = op(mode.from_tensor(a), None if b is None
                  else mode.from_tensor(b), mode.from_tensor(amax))
    for r, f in zip(real, fake):
        assert (r.shape, r.dtype, r.stride()) == (f.shape, f.dtype,
                                                  f.stride())
    # q's rows 16 bytes apart, f empty without the addend
    assert real[0].stride(-2) == -(-c // 16) * 16
    assert real[1].shape == ((2, 4, 4, c) if with_b else (0,))


def test_refuses_what_it_cannot_take():
    a = torch.randn(2, 3, 16)
    amax = torch.tensor(1.0)
    with pytest.raises(TypeError):
        iq.int8_quantize(a.double(), amax)
    with pytest.raises(ValueError):
        iq.int8_quantize(a, amax, a.bfloat16())
    with pytest.raises(ValueError):
        iq.int8_quantize(a, amax, a[:1])
    with pytest.raises(ValueError):
        iq.int8_quantize(a, amax.reshape(1))


class OpCount(TorchDispatchMode):
    """Counts the operators that reach the dispatcher (a custom op once,
    not the operators inside its CPU form)."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func._schema.name] += 1
        return func(*args, **(kwargs or {}))


def test_lite_forward_issues_one_op_a_step():
    """A calibrated s2/f16 lite forward (J = 21, 32x32): every standalone
    step one ``densereg::int8_quantize``, and no round or clamp outside an
    op."""
    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=21, input_hw=(32, 32),
                    net_module="um_v1_lite")
    rng = np.random.default_rng(8)
    x = torch.from_numpy(seeded_depth(rng, 3, 32, 32))
    qtree = quantize_weights(fold_batch_norm(init_variables(cfg, seed=8),
                                             cfg.bn_epsilon))
    net = calibrate(from_flax(qtree, cfg), [x])
    before = dict(layers.int8_counts)
    mode = OpCount()
    with torch.inference_mode(), mode:
        net(x)
    steps = layers.int8_counts["quantize"] - before["quantize"]
    assert steps == 53
    assert mode.calls["densereg::int8_quantize"] == steps
    assert mode.calls["aten::round"] == 0 and mode.calls["aten::clamp"] == 0
    assert layers.int8_counts["quantize_kernel"] == before["quantize_kernel"]


def test_calibration_issues_one_op_a_step():
    """Calibrating the same net: every standalone step is one
    ``densereg::int8_quantize`` too (with the batch's own maximum), and
    the recorded maxima are the batch's ``max|x|`` of each step's input."""
    cfg = NetConfig(num_stack=2, num_fea=16, num_joint=21, input_hw=(32, 32),
                    net_module="um_v1_lite")
    rng = np.random.default_rng(9)
    x = torch.from_numpy(seeded_depth(rng, 3, 32, 32))
    qtree = quantize_weights(fold_batch_norm(init_variables(cfg, seed=9),
                                             cfg.bn_epsilon))
    before = dict(layers.int8_counts)
    mode = OpCount()
    with mode:
        net = calibrate(from_flax(qtree, cfg), [x])
    # while calibrating every convolution quantizes its own output too
    steps = layers.int8_counts["quantize"] - before["quantize"]
    assert steps > 53
    assert mode.calls["densereg::int8_quantize"] == steps
    assert mode.calls["aten::round"] == 0 and mode.calls["aten::clamp"] == 0
    first = next(m for m in net.modules() if isinstance(m, layers.ConvBR)
                 and m.amax is not None)
    assert first.amax.dtype == torch.float32 and first.amax.dim() == 0
    assert torch.equal(first.amax, x.float().abs().amax())
