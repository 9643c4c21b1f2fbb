"""Share of the int8 net's standalone quantize steps that ran as one launch
of the program's quantize kernel, %: ``models.layers.int8_counts``'s
``quantize_kernel`` over its ``quantize``, over the window's forwards. None
where the program keeps no ``quantize_kernel`` count (a program without
the kernel) or ran no step."""


def read(run):
    steps = run.counters.get("quantize")
    if "quantize_kernel" not in run.counters or not steps:
        return None
    return 100.0 * run.counters["quantize_kernel"] / steps
