"""Share of a traced training step's forward and backward passes that
replay the step's CUDA graph, %: the program's
``densereg.train.forward_backward`` spans that hold a
``densereg.train.graph_replay`` span, over all of them. None where the
trace holds no replay span (a program without the graph)."""


def read(run):
    t = run.trace
    if t is None:
        return None
    passes = t.ranges("densereg.train.forward_backward")
    replays = sorted(t.ranges("densereg.train.graph_replay"))
    if not passes or not replays:
        return None
    held = sum(any(a <= r0 and r1 <= b for r0, r1 in replays)
               for a, b in passes)
    return 100.0 * held / len(passes)
