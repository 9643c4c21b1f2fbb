"""Frames a dispatch of the serving daemon over the window, from integer
differences of its ``stats()`` counters (batches, and the frames batched:
``mean_batch`` times ``batches``) taken at the window's edges."""


def read(run):
    batches = run.counters.get("batches")
    if not batches:
        return None
    return run.counters["batched_frames"] / batches
