"""``quantize_kernel_share.batch_int8`` on hand-made counters: the share of
standalone quantize steps that launched the quantize kernel, and None
where the program keeps no such count or ran no step."""

import pytest

import common


@pytest.mark.parametrize("counters,want", [
    ({"quantize": 690, "quantize_kernel": 690, "forwards": 10}, 100.0),
    ({"quantize": 690, "quantize_kernel": 345, "forwards": 10}, 50.0),
    ({"quantize": 530, "quantize_kernel": 0, "forwards": 10}, 0.0),
    ({"quantize": 690, "forwards": 10}, None),
    ({"quantize": 0, "quantize_kernel": 0, "forwards": 0}, None),
    ({}, None)])
def test_share_of_steps_on_the_kernel(counters, want):
    got = common.reader("quantize_kernel_share.batch_int8")(
        common.Run({}, {}, counters=counters))
    assert got == (None if want is None else pytest.approx(want))
