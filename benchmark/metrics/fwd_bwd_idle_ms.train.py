"""Device idle time under the forward and backward passes a training step,
ms: the part of the trace's idle intervals (no kernel, copy or memset
running) that the program's ``densereg.train.forward_backward`` spans
cover and its ``densereg.train.augment_targets`` spans, which sit inside
them, do not: the host's launches holding the device back. Over the
``densereg.train.step`` spans."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    passes = t.ranges("densereg.train.forward_backward")
    steps = t.ranges("densereg.train.step")
    if not passes or not steps:
        return None
    idle = _intersect(_idle(t), _union(passes))
    augment = _intersect(idle, _union(
        t.ranges("densereg.train.augment_targets")))
    idle_us = sum(b - a for a, b in idle) - sum(b - a for a, b in augment)
    return idle_us / 1e3 / len(steps)


def _union(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersect(xs, ys):
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _idle(t):
    """The window's intervals with no kernel, copy or memset running."""
    out, edge = [], t.t0
    for a, b in t.busy_intervals():
        if a > edge:
            out.append((edge, a))
        edge = max(edge, b)
    if t.t1 > edge:
        out.append((edge, t.t1))
    return out
