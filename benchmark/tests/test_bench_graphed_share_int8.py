"""``graphed_share.batch_int8`` on the hand-made serving trace of
``test_bench_spans``: replay spans inside some of its network passes give
the share of passes that hold one, and a trace without a replay span (a
program without the graph) gives None."""

import pytest

import common
from test_bench_spans import BATCH, run_of, span

# the window's passes: (35, 60) and (130, 150); a replay inside the first,
# one inside the second, and one that straddles the second's end, which
# no pass holds
REPLAYS = [span("int8.graph_replay", a, b)
           for a, b in ((36, 59), (131, 149), (145, 155))]


@pytest.mark.parametrize("replays,want", [
    (REPLAYS, 100.0), (REPLAYS[:1], 50.0), (REPLAYS[2:], 0.0), ([], None)])
def test_share_of_passes_holding_a_replay(replays, want, tmp_path):
    got = common.reader("graphed_share.batch_int8")(run_of(BATCH + replays,
                                                           tmp_path))
    assert got == (None if want is None else pytest.approx(want))
    assert common.reader("graphed_share.batch_int8")(
        common.Run({}, {})) is None
