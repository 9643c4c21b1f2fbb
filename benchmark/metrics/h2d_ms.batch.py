"""Host-to-device copy time a dispatch, ms: the device's memcpy events
from host memory in the traced window, over the dispatches made there."""


def read(run):
    if run.trace is None or not run.counts.get("dispatches"):
        return None
    copies = run.trace.events("gpu_memcpy", "HtoD")
    if not copies:
        return None
    return run.trace.seconds("gpu_memcpy", "HtoD") * 1e3 / run.counts[
        "dispatches"]
