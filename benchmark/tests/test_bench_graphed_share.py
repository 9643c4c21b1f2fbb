"""``graphed_share.train`` on the hand-made training trace of
``test_bench_spans``: replay spans inside some of its forward and backward
passes give the share of passes that hold one, and a trace without a
replay span (a program without the graph) gives None."""

import pytest

import common
from test_bench_spans import TRAIN, run_of, span

# the trace's passes: (20, 50), (50, 80), (140, 170), (170, 185); a replay
# inside the first, the third and the fourth, and one that straddles the
# first two, which no pass holds
REPLAYS = [span("train.graph_replay", a, b)
           for a, b in ((31, 49), (45, 55), (151, 169), (173, 184))]


@pytest.mark.parametrize("replays,want", [
    (REPLAYS, 100.0 * 3 / 4), (REPLAYS[2:], 50.0), ([], None)])
def test_share_of_passes_holding_a_replay(replays, want, tmp_path):
    got = common.reader("graphed_share.train")(run_of(TRAIN + replays,
                                                      tmp_path))
    assert got == (None if want is None else pytest.approx(want))
    assert common.reader("graphed_share.train")(common.Run({}, {})) is None
