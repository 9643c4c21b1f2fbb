"""The whole training step's share of the chip's float32 peak (TF32 off),
%: the forward and both backward products of every convolution a sample
(``counting.train_flops``) times the samples of the traced steps, over
the traced window's length times 67 TFLOP/s."""

import counting


def read(run):
    if run.trace is None or not run.counts.get("samples"):
        return None
    flops = counting.train_flops(run.config) * run.counts["samples"]
    peak = counting.PEAK_FLOPS[run.config["compute_dtype"]]
    return 100.0 * flops / (run.trace.window_s * peak)
