"""Device time of the network a dispatch, ms: the kernels launched inside
the program's ``densereg.net`` spans, joined to their launches by
correlation id, over the ``densereg.dispatch`` spans of the traced window;
the program's own counterpart of ``net_ms.batch``."""


def read(run):
    t = run.trace
    if t is None:
        return None
    per = len(t.ranges("densereg.dispatch"))
    kernels = t.kernels_launched_in("densereg.net")
    if not per or not kernels:
        return None
    return sum(k.get("dur", 0) for k in kernels) / 1e3 / per
