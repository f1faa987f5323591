"""Timer spans and the timing registry (torch).

Counterpart of ``dolfinx_mpc_tpu/utils/timing.py``, with its names and
registry: every phase runs in a ``~MPC:``-prefixed span (the reference's
``dolfinx::common::Timer``), each span adds its host wall time to a global
registry (calls, total, max), and ``list_timings`` prints it.  Where the
JAX package opens a ``jax.profiler.TraceAnnotation`` so that the names show
up in a TPU trace, a span here pushes an NVTX range while CUDA is
available, so that they show up in a CUDA trace.  A span reads the host
clock only: it adds no device synchronisation, so on the card it measures
the time to enqueue the phase's work, not the device time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["Timer", "timed", "list_timings", "reset_timings", "timings"]

_registry: dict = defaultdict(lambda: [0, 0.0, 0.0])  # name -> [count, total, max]


class Timer:
    """`with Timer("~MPC: Assemble matrix"):` — accumulates into the global
    registry; also usable as start()/stop() like the dolfinx Timer."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = None
        self._nvtx = False

    def start(self):
        self._t0 = time.perf_counter()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        rec = _registry[self.name]
        rec[0] += 1
        rec[1] += dt
        rec[2] = max(rec[2], dt)
        return dt

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def __enter__(self):
        return self.start()

    def __exit__(self, *a):
        self.stop()


@contextmanager
def timed(name: str):
    t = Timer(name).start()
    try:
        yield t
    finally:
        t.stop()


def timings() -> dict:
    """{name: (count, total_s, max_s)}"""
    return {k: tuple(v) for k, v in _registry.items()}


def reset_timings():
    _registry.clear()


def list_timings(comm=None, file=None):
    """Print the registry (reference `list_timings(comm)` shape)."""
    rows = sorted(_registry.items())
    w = max((len(k) for k, _ in rows), default=10)
    print(f"{'name':{w}s} {'calls':>6s} {'total[s]':>10s} {'avg[s]':>10s} {'max[s]':>10s}", file=file)
    for k, (cnt, tot, mx) in rows:
        print(f"{k:{w}s} {cnt:6d} {tot:10.4f} {tot/max(cnt,1):10.4f} {mx:10.4f}", file=file)
