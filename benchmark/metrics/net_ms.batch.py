"""Device time of the network a dispatch, ms: the kernels launched inside
the benchmark's ``bench.net`` ranges (forward hooks on the predictor's
net), joined to their launches by correlation id, over the dispatches of
the traced window."""


def read(run):
    if run.trace is None or not run.counts.get("dispatches"):
        return None
    kernels = run.trace.kernels_launched_in("bench.net")
    if not kernels:
        return None
    return sum(k.get("dur", 0) for k in kernels) / 1e3 / run.counts[
        "dispatches"]
