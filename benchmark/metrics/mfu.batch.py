"""The whole serving step's share of the chip's peak, %: the network's
forward operations a frame (``counting.forward_flops``) times the frames
the traced window completed, over the window's length times the
configuration's dtype's peak."""

import counting


def read(run):
    if run.trace is None or not run.counts.get("frames"):
        return None
    flops = counting.forward_flops(run.config) * run.counts["frames"]
    peak = counting.PEAK_FLOPS[run.config["compute_dtype"]]
    return 100.0 * flops / (run.trace.window_s * peak)
