"""Timer spans, counters and their two tables (torch).

Counterpart of ``dolfinx_mpc_tpu/utils/timing.py``, with its names and
registry: every phase of the public API runs in a ``~MPC:``-prefixed span
(the reference's ``dolfinx::common::Timer``), each span adds its host wall
time to a global registry (calls, total, max), ``timings`` returns it and
``list_timings`` prints it.

The same span type times the port's inner phases into a second table, which
``trace_timings`` returns: ``span(name)`` (or ``traced(name)`` around a whole
function) opens one, ``count(name, n)`` sums an amount into the same table
(calls, total, max of the amounts).  ``reset_timings`` clears both tables.
The inner names are fixed: ``gmg.vcycle``, ``gmg.L<l>.pre`` / ``.down`` /
``.up`` / ``.post``, ``gmg.coarse`` (la/gmg.py); ``lattice.to_blocked``,
``lattice.from_blocked`` (ops/lattice.py: the padded class stack's
conversions); ``csr.to_scipy``
(la/sparse.py); ``bell.pack``, ``bell.upload`` and the counters
``bell.upload_bytes``, ``bell.plan_hit`` and ``bell.plan_miss``
(la/bell.py); ``amg.setup``, ``amg.aggregate``, ``amg.prolongator``,
``amg.galerkin``, ``amg.to_device``, ``amg.coarse_inverse``, ``amg.vcycle``
(la/amg.py); the counters ``gmg.graph_capture``, ``gmg.graph_replay``,
``amg.graph_capture`` and ``amg.graph_replay`` (la/cycle_graph.py: each
V-cycle's CUDA graph).  ``CallRecord`` records the calls that spans and
counters add while it is open and adds them again, with no seconds, for
work that ran without its spans' host code: a captured graph's replay.

A span reads the host clock only and adds no device synchronisation, so on
the card it measures the time to enqueue its phase's work.  While a torch
profiler records, a span also opens a profiler range of its name, so that
the names sit in the profiler's trace (``export_chrome_trace``) on its
clock, nested as the calls nest, around the launches of their kernels.  The
range has function scope, as an operator's has: ``record_function``'s user
scope would also put a copy of every span on the device's timeline, where
it reads as device work.  With no profiler recording, a span makes no torch
or CUDA call past that one flag check.  Under Nsight Systems,
``torch.autograd.profiler.emit_nvtx()`` turns the ranges into NVTX ranges.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

__all__ = ["Timer", "timed", "list_timings", "reset_timings", "timings"]

_registry: dict = defaultdict(lambda: [0, 0.0, 0.0])  # ~MPC: spans: name -> [count, total, max]
_trace: dict = defaultdict(lambda: [0, 0.0, 0.0])  # inner spans and counters, the same form
_profiling = torch._C._autograd._profiler_enabled


def _add(table, name, v):
    rec = table[name]
    rec[0] += 1
    rec[1] += v
    if v > rec[2]:
        rec[2] = v


class Timer:
    """`with Timer("~MPC: Assemble matrix"):` — accumulates into the global
    registry; also usable as start()/stop() like the dolfinx Timer.
    `table`: the registry (default) or the trace table (what ``span``
    passes)."""

    __slots__ = ("name", "_table", "_t0", "_range")

    def __init__(self, name: str, table: dict = _registry):
        self.name = name
        self._table = table
        self._t0 = None
        self._range = None

    def start(self):
        if _profiling():
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        _add(self._table, self.name, dt)
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


def span(name: str) -> Timer:
    """A span of the port's inner phases: `with span("gmg.coarse"):`."""
    return Timer(name, _trace)


def traced(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n) -> None:
    """Add the amount n to the counter `name` of the trace table."""
    _add(_trace, name, n)


class CallRecord:
    """The calls that spans and counters add to the trace table while the
    record is open (``with rec:``), by name in ``calls``.  ``add(times)``
    adds them again ``times`` times over with no seconds (totals and maxima
    stay); a negative number takes them back."""

    def __init__(self):
        self.calls = {}
        self._before = None

    def __enter__(self):
        self._before = {k: v[0] for k, v in _trace.items()}
        return self

    def __exit__(self, *a):
        before = self._before
        self.calls = {k: v[0] - before.get(k, 0) for k, v in _trace.items() if v[0] != before.get(k, 0)}

    def add(self, times=1):
        for name, n in self.calls.items():
            _trace[name][0] += times * n


def timings() -> dict:
    """{name: (count, total_s, max_s)}"""
    return {k: tuple(v) for k, v in _registry.items()}


def trace_timings() -> dict:
    """The trace table, {name: (calls, total, max)}: seconds for a span,
    the amounts for a counter."""
    return {k: tuple(v) for k, v in _trace.items()}


def reset_timings():
    _registry.clear()
    _trace.clear()


def list_timings(comm=None, file=None):
    """Print the registry (reference `list_timings(comm)` shape)."""
    rows = sorted(_registry.items())
    w = max((len(k) for k, _ in rows), default=10)
    print(f"{'name':{w}s} {'calls':>6s} {'total[s]':>10s} {'avg[s]':>10s} {'max[s]':>10s}", file=file)
    for k, (cnt, tot, mx) in rows:
        print(f"{k:{w}s} {cnt:6d} {tot:10.4f} {tot/max(cnt,1):10.4f} {mx:10.4f}", file=file)
