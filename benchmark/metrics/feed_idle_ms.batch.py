"""Device idle time under the host feed a dispatch, ms: the part of the
traced window's idle intervals (no kernel, copy or memset running) that the
program's ``densereg.feed`` spans cover (the pinned host copy and the
copy's enqueue, ``Predictor._to_device``), over its ``densereg.dispatch``
spans."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    feeds = t.ranges("densereg.feed")
    dispatches = t.ranges("densereg.dispatch")
    if not feeds or not dispatches:
        return None
    idle = _intersect(_idle(t), _union(feeds))
    return sum(b - a for a, b in idle) / 1e3 / len(dispatches)


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
