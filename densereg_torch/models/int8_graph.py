"""The int8 net's eval forward replayed as one CUDA graph for each input
shape.

An int8 forward (``DenseRegNet`` with ``cfg.quantize``, calibrated or
dynamic) on the card is ~1,400 launches on the current stream: K3, DW and
Q (``ops/``) and the per-convolution scale scalars between them, with no
host sync and every scale a device tensor. Issuing them takes the host
longer than the card takes to run them, so :class:`Int8ForwardGraph`
captures the forward once per input shape and replays it: the same
hand-written kernels with the same arguments, in one launch.
``serving.ServingModule`` reaches it for every dispatch.
"""

from __future__ import annotations

import copy
from typing import Dict, List, NamedTuple, Tuple

import torch
from torch import nn

from densereg_torch.models.layers import int8_counts
from densereg_torch.utils.profiling import span


class _Captured(NamedTuple):
    """One shape's graph, its static input and outputs, and the stamp
    (:meth:`Int8ForwardGraph._stamp`) it was captured at."""
    graph: torch.cuda.CUDAGraph
    x: torch.Tensor
    outs: Dict[str, List[torch.Tensor]]
    stamp: Tuple


class Int8ForwardGraph:
    """``net``'s eval forward as a CUDA graph, one for each input shape,
    dtype and device.

    :meth:`engaged` says where it runs: on a CUDA device, for an int8 net,
    with no module calibrating, no grad recorded and no ``torch.export``
    or ``torch.compile`` tracing (an exported program holds the eager
    forward). Elsewhere the caller runs ``net`` itself.

    The first call of a shape runs the forward eagerly and returns its
    answer, which packs the weights and loads the kernels; then it
    captures the forward on a side stream, reading a static input. Each
    later call copies its input into that buffer on the current stream and
    replays the graph there, and returns the graph's static outputs: the
    next replay of that shape overwrites them, so a caller reads them on
    the same stream before its next call, or copies them. A shape is
    captured again, after another eager call, wherever a parameter or
    buffer of ``net`` has moved or changed since (``data_ptr`` and
    ``_version``; ``amax``, ``out_amax``, ``kernel_q`` and ``w_packed``
    among them), so a later ``calibrate()`` or weight update never replays
    stale addresses. Each shape's graph keeps its own memory pool.

    :data:`int8_counts` and the kernels' launch counters
    (``ops._build.Kernel``) count the calls made on the host: the eager
    call's and the capture's, none of a replay's. A replay is counted in
    ``int8_counts["graph_replays"]`` alone (a capture in
    ``["graph_captures"]``), and the span ``densereg.int8.graph_replay``
    marks it; the kernels it runs are seen in a device trace, by their
    symbols. A module copy of a serving mesh's other cards holds its
    own object, which captures on that replica's own device."""

    def __init__(self, net: nn.Module):
        self.net = net
        self.quantized = bool(net.cfg.quantize)
        mods = list(net.modules())
        self._calibrating = [m for m in mods if hasattr(m, "calibrating")]
        # the dicts and names of every parameter and buffer, None ones
        # too: a buffer set or replaced is seen through its dict
        self._slots = [(d, name) for m in mods
                       for d in (m._parameters, m._buffers) for name in d]
        self._graphs: Dict[tuple, _Captured] = {}

    def __deepcopy__(self, memo):
        return Int8ForwardGraph(copy.deepcopy(self.net, memo))

    def engaged(self, device: torch.device) -> bool:
        """Whether a forward on ``device`` runs through the graph."""
        return (self.quantized and device.type == "cuda"
                and not torch.compiler.is_compiling()
                and not torch.is_grad_enabled()
                and not any(m.calibrating for m in self._calibrating))

    def _stamp(self) -> Tuple:
        """Where each parameter and buffer lies and its version (an
        inference tensor keeps none)."""
        return tuple(
            None if t is None else
            (t.data_ptr(), -1 if t.is_inference() else t._version)
            for d, name in self._slots for t in (d[name],))

    def __call__(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        key = (tuple(x.shape), x.dtype, x.device)
        cap = self._graphs.get(key)
        if cap is not None and cap.stamp == self._stamp():
            cap.x.copy_(x)
            with span("densereg.int8.graph_replay"):
                cap.graph.replay()
            int8_counts["graph_replays"] += 1
            return cap.outs
        outs = self.net(x)
        self._capture(key, x)
        return outs

    def _capture(self, key: tuple, x: torch.Tensor) -> None:
        self._graphs.pop(key, None)          # a stale graph's pool first
        with torch.inference_mode(False):    # a buffer any mode may fill
            static = torch.empty_like(x)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(x.device), torch.cuda.graph(
                graph, stream=torch.cuda.Stream(x.device),
                capture_error_mode="thread_local"):
            outs = self.net(static)
        int8_counts["graph_captures"] += 1
        self._graphs[key] = _Captured(graph, static, outs, self._stamp())
