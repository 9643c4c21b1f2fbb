"""Step timing, traces and the program's spans.

:class:`StepTimer` is the JAX package's wall-clock step timer
(``densereg_tpu/utils/profiling.py``); on a CUDA device it synchronises
the device before it reads the clock, so a step's time includes its
device work. :func:`start_trace` and :func:`stop_trace` start and write a
``torch.profiler`` trace (the host, and the card on CUDA);
:func:`trace_context` traces a block with them, and the training loop
traces ``TrainConfig.profile_dir``'s steps with them.

:func:`span` opens a named range in that trace, on the thread that
launches the work, so a range shares the clock of the kernels and copies
it issues. Spans nest by time on one thread: a dispatch's spans sit inside
its request's span, and that nesting is what ties them together. No span
sits inside the float network's layers (a training step issues tens of
thousands of kernels); in the int8 net each standalone quantize step
opens one, which a serving forward on the card replays as a CUDA graph
without it. The spans:

span (once per)                      where
``densereg.predict`` (request)       ``host_loop.HostLoop.__call__`` (the
                                     live and the exported predictor)
``densereg.dispatch`` (chunk)        ``HostLoop._dispatch``: pad, feed,
                                     enqueue
``densereg.feed`` (tensor fed)       ``HostLoop._to_device``: the pinned host
                                     copy and the copy's enqueue
``densereg.preprocess`` (chunk)      ``ServingModule.normed``: crop, center of
                                     mass, ``norm_dm``
``densereg.net`` (chunk)             the network's forward in ``ServingModule``
``densereg.int8.quantize`` (step)    the int8 net's standalone quantize
                                     steps (``models.layers``: a
                                     convolution's quantize of a float
                                     input, ``quantize_output`` of a sum);
                                     a serving forward on the card opens
                                     them only while its graph is captured
``densereg.int8.graph_replay``       ``models.int8_graph.Int8ForwardGraph``:
  (int8 forward on the card)         the replay of the int8 net's CUDA
                                     graph; inside ``densereg.net``
``densereg.decode`` (chunk)          the head-grid subsample and
                                     ``decode_poses``
``densereg.fetch`` (chunk)           a chunk's copy to the host in
                                     ``HostLoop.__call__``
``densereg.train.step`` (step)       one iteration of ``train.loop.train``'s
                                     loop, inside the profiler's start and stop
``densereg.pipeline.wait`` (batch)   ``InputPipeline``'s wait on its producers
``densereg.pipeline.feed`` (batch)   ``InputPipeline``'s copy to the device and
                                     crop (or wire decode)
``densereg.train.augment_targets``   ``train.state.augment_targets``:
  (micro-batch)                      augmentation, ``norm_dm``,
                                     ``targets.synthesize``
``densereg.train.forward_backward``  a micro-batch's ``loss_fn`` call and its
  (micro-batch)                      ``backward()``, or where the step is
                                     graphed its augment_targets and
                                     graph_replay; holds augment_targets
``densereg.train.graph_replay``      ``train.step.MicroBatchGraph``: the replay
  (graphed micro-batch)              of the forward and backward's CUDA graph
                                     and the copy of its losses; inside
                                     forward_backward
``densereg.train.all_reduce`` (call) ``train.step.all_reduce_sum_``
``densereg.train.optimizer`` (step)  ``train_step``'s update: the division, the
                                     norms, ``ClippedAdam.step``, the EMA

With no profiler recording on the calling thread, or while
``torch.export`` or ``torch.compile`` traces, a span is one shared null
context: its cost is two flag checks, and a traced program holds no
profiler op.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a profiler records on this
    thread; the shared null context otherwise."""
    if torch.compiler.is_compiling() or not _recording():
        return _OFF
    return record_function(name)


def _sync(device: Optional[torch.device]) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


class StepTimer:
    """Rolling wall-clock stats; use as a context manager around each
    step. ``last`` is the last step's seconds, ``mean`` the mean after
    ``warmup`` steps."""

    def __init__(self, warmup: int = 1, device=None):
        self.warmup = warmup
        self.device = None if device is None else torch.device(device)
        self.count = 0
        self.total = 0.0
        self.last = 0.0
        self._t0: Optional[float] = None

    def __enter__(self):
        _sync(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.last = time.perf_counter() - self._t0
        self.count += 1
        if self.count > self.warmup:
            self.total += self.last

    @property
    def mean(self) -> float:
        n = self.count - self.warmup
        return self.total / n if n > 0 else float("nan")


def start_trace(device: torch.device):
    """Start ``torch.profiler`` on the host and, on a CUDA device, the
    device; returns the profiler for :func:`stop_trace`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, path: str, device: torch.device) -> str:
    """Stop the trace once the device is done and write it to ``path`` as
    a Chrome trace (its directory made); returns ``path``."""
    _sync(device)
    prof.stop()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace_context(logdir: Optional[str]):
    """``torch.profiler`` trace of the block (the host, and the card where
    CUDA is available) written into ``logdir`` as a Chrome trace,
    ``trace_<time ns>.pt.trace.json``, when a logdir is given; no-op
    otherwise."""
    if not logdir:
        yield
        return
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    prof = start_trace(device)
    try:
        yield
    finally:
        stop_trace(prof, os.path.join(
            logdir, f"trace_{time.time_ns()}.pt.trace.json"), device)
