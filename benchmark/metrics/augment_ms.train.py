"""Device time of augmentation and targets a training step, ms: the
kernels launched inside the program's ``densereg.train.augment_targets``
spans (augmentation, ``norm_dm``, ``targets.synthesize``), joined to their
launches by correlation id, over the ``densereg.train.step`` spans of the
trace."""


def read(run):
    t = run.trace
    if t is None:
        return None
    per = len(t.ranges("densereg.train.step"))
    kernels = t.kernels_launched_in("densereg.train.augment_targets")
    if not per or not kernels:
        return None
    return sum(k.get("dur", 0) for k in kernels) / 1e3 / per
