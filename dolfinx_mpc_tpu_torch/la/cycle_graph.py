"""A multigrid V-cycle replayed as one CUDA graph per input layout: the
capture and replay that the lattice GMG (la/gmg.py) and the
smoothed-aggregation AMG (la/amg.py) share.

``run_cycle(graphs, cycle, r, prefix, wrappers)`` applies ``cycle`` to r
inside the span ``<prefix>.vcycle``.  A CPU input runs the eager cycle.  A
CUDA input looks its layout (shape, dtype, device) up in ``graphs``, the
caller's own table: the first call with a layout runs one eager cycle on a
side stream (which prepares the operators' launches and the kernels'
shared-memory opt-ins), then captures the cycle once with a static input and
output; every call copies the input in, replays the graph and returns a copy
of the output.  The counts keep reading what the device runs: each replay
adds the span calls (with no seconds) and the launch counts of ``wrappers``
that one captured cycle made, and the counters ``<prefix>.graph_capture`` and
``<prefix>.graph_replay`` count captures and replays.  A graph keeps the
tensors it captured alive and reads them in place, so the operators the
cycle reads must stay fixed once it is built.
"""

from __future__ import annotations

import torch

from .._launch import LaunchRecord
from ..utils.timing import CallRecord, count, span

__all__ = ["CycleGraph", "run_cycle"]


class CycleGraph:
    """A captured V-cycle: the graph, its static input and output, and the
    span calls and launch counts of one cycle.  No __slots__: the sharded
    path's memory_report walks the attributes (vars) of the port's objects,
    a LatticeGMG's graph table (a tail's own) among them, and counts the
    static buffers as the replicated hierarchy's."""

    def __init__(self, graph, x, y, spans, launches):
        self.graph, self.x, self.y, self.spans, self.launches = graph, x, y, spans, launches


def run_cycle(graphs, cycle, r, prefix, wrappers):
    """cycle(r) inside the span <prefix>.vcycle: eager on a CPU input,
    replayed from ``graphs`` (captured on first use) on a CUDA input."""
    with span(prefix + ".vcycle"):
        if r.device.type != "cuda":
            return cycle(r)
        with torch.cuda.device(r.device):  # replay() launches on the current device's stream
            return replay(graphs, cycle, r, prefix, wrappers)


def replay(graphs, cycle, r, prefix, wrappers):
    """One replay of the graph of r's layout, captured first if ``graphs``
    has none; returns a copy of the static output."""
    key = (tuple(r.shape), r.dtype, r.device)
    g = graphs.get(key)
    if g is None:
        g = graphs[key] = capture(cycle, r, prefix, wrappers)
    g.x.copy_(r)
    g.graph.replay()
    g.spans.add()
    g.launches.add()
    count(prefix + ".graph_replay", 1)
    # a copy: CG keeps the first output (p = z) while the next replay
    # writes the static one
    return g.y.clone()


def capture(cycle, r, prefix, wrappers):
    """The cycle on inputs like r as a CycleGraph: one eager cycle on a side
    stream first (it runs on the device and counts as the cycle it is), then
    the capture, whose span calls and launch counts are taken back (it runs
    nothing) and kept for the replays to add."""
    side = torch.cuda.Stream(r.device)
    side.wait_stream(torch.cuda.current_stream(r.device))
    with torch.cuda.stream(side):
        cycle(r)
    torch.cuda.current_stream(r.device).wait_stream(side)
    x = torch.empty(r.shape, dtype=r.dtype, device=r.device)
    x.copy_(r)
    graph = torch.cuda.CUDAGraph()
    spans, launches = CallRecord(), LaunchRecord(wrappers)
    # "thread_local": only this thread's capture-unsafe calls void the
    # capture; another thread's (a gloo rank's staging, a data loader)
    # cannot, as it could under the default "global"
    with spans, launches, torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
        y = cycle(x)
    spans.add(-1)
    launches.add(-1)
    count(prefix + ".graph_capture", 1)
    return CycleGraph(graph, x, y, spans, launches)
