"""The control, at a small size on the CPU: computed one precision below
the configuration's, it comes out not correct under the committed limits,
where the program at the same size comes out correct; so does the planted
half-batch fault of the training reference."""

import pytest

import common
import control
from conftest import SMALL, SMALL_TRAFFIC


def limits(name):
    _, _, cfg, tr = common.load_cell(name)
    return cfg["limits"][tr["kind"]], SMALL_TRAFFIC[tr["kind"]]


def correct(readings, lim):
    return all(v <= lim[k] for k, v in readings.items())


@pytest.mark.parametrize("name", ["nyu14-bf16-batch1024",
                                  "icvl16-f32-batch1024",
                                  "icvl16-f32-train40x5"])
def test_control_fails_where_the_program_passes(name):
    lim, small_traffic = limits(name)
    prog = control.readings(name, 5, "program", "cpu", SMALL, small_traffic)
    assert all(correct(r, lim) for r in prog.values())
    ctl = control.readings(name, 6, "control", "cpu", SMALL, small_traffic)
    assert ctl and not any(correct(r, lim) for r in ctl.values())
