"""Standalone quantize steps a forward of the int8 net: the program's
``models.layers.int8_counts["quantize"]`` over the window, over the
forwards the window ran. A quantization fused into a kernel's epilogue is
not one."""


def read(run):
    if "quantize" not in run.counters or not run.counters.get("forwards"):
        return None
    return run.counters["quantize"] / run.counters["forwards"]
