"""Device time of the serving preprocess a dispatch, ms: the kernels
launched inside the program's ``densereg.preprocess`` spans (crop, center
of mass, ``norm_dm``), joined to their launches by correlation id, over
the ``densereg.dispatch`` spans of the traced window."""


def read(run):
    t = run.trace
    if t is None:
        return None
    per = len(t.ranges("densereg.dispatch"))
    kernels = t.kernels_launched_in("densereg.preprocess")
    if not per or not kernels:
        return None
    return sum(k.get("dur", 0) for k in kernels) / 1e3 / per
