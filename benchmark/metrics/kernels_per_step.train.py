"""Device kernels launched a training step: the kernel events of the
traced steps over their number."""


def read(run):
    if run.trace is None or not run.counts.get("steps"):
        return None
    kernels = run.trace.events("kernel")
    if not kernels:
        return None
    return len(kernels) / run.counts["steps"]
