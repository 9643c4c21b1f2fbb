"""Share of a traced int8 serving window's network passes that replay the
int8 net's CUDA graph, %: the program's ``densereg.net`` spans that hold a
``densereg.int8.graph_replay`` span, over all of them. None where the
trace holds no replay span (a program without the graph)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    passes = t.ranges("densereg.net")
    replays = t.ranges("densereg.int8.graph_replay")
    if not passes or not replays:
        return None
    held = sum(any(a <= r0 and r1 <= b for r0, r1 in replays)
               for a, b in passes)
    return 100.0 * held / len(passes)
