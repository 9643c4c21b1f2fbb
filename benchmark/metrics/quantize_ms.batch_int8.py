"""Device time of the int8 net's standalone quantize steps a dispatch, ms:
the kernels launched inside the program's ``densereg.int8.quantize`` spans
(a convolution's quantize of a float input, the quantization of a sum, and
their scales), joined to their launches by correlation id, over the
``densereg.dispatch`` spans of the traced window."""


def read(run):
    t = run.trace
    if t is None:
        return None
    per = len(t.ranges("densereg.dispatch"))
    kernels = t.kernels_launched_in("densereg.int8.quantize")
    if not per or not kernels:
        return None
    return sum(k.get("dur", 0) for k in kernels) / 1e3 / per
