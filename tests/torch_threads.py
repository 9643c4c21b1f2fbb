"""Caps torch's intra-op threads in a pytest-xdist worker.

Each xdist worker is a process of its own; left alone, torch gives every
one of them as many intra-op threads as the machine has cores, so the
workers' threads oversubscribe the cores many times over (beside XLA's own
pools in the same processes) and the CPU tests run an order of magnitude
slower than alone. In a worker the cap is the worker's share of the cores;
outside xdist torch is left as it is.
"""

import os


def cap_torch_threads(torch) -> None:
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(workers, 1)))
