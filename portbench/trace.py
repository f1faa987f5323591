"""Spans and the profiler's trace of one run, taken from the benchmark's
own files around the calls into each layer of the port.

A Tracer runs in one of three modes: "off" (the measured runs: a span costs
nothing), "profile" (a torch.profiler record_function per span, no
synchronisation, so the device trace shows the layers as they run) and
"timed" (a synchronize on either side of each span and the host clock
between, summed per request).  Set-up spans are timed in every mode: they
lie outside the window."""

import time
from contextlib import contextmanager, nullcontext

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
TOP = 10  # entries of each breakdown list


class Tracer:
    def __init__(self, mode, sync):
        if mode not in ("off", "profile", "timed"):
            raise ValueError(f"unknown tracer mode {mode!r}")
        self.mode = mode
        self.sync = sync
        self.spans = {}  # seconds per span name, this request
        self.setup = {}  # seconds per set-up span name
        self.names = set()

    @contextmanager
    def setup_span(self, name):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.setup[name] = self.setup.get(name, 0.0) + time.perf_counter() - t0

    def span(self, name):
        if self.mode == "off":
            return nullcontext()
        self.names.add(name)
        if self.mode == "profile":
            import torch

            return torch.profiler.record_function(name)
        return self._timed(name)

    @contextmanager
    def _timed(self, name):
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def wrap(self, name, fn):
        """fn itself when off, else fn inside the span `name` at each call."""
        if self.mode == "off":
            return fn

        def traced(*args):
            with self.span(name):
                return fn(*args)

        return traced

    def take(self):
        """This request's span seconds; starts the next request's."""
        out, self.spans = self.spans, {}
        return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_profile(prof, names):
    """Busy seconds, window seconds, launch calls and the breakdown lists
    of a torch.profiler run.  `names` are the span names whose intervals
    label the idle gaps (the innermost span open at a gap's midpoint; "host"
    where none is)."""
    from torch.autograd import DeviceType

    events = prof.events()
    device, spans, launches, lo, hi = [], [], 0, None, None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # the device timeline also carries the spans' own annotations and
            # the host's waits (Context / Stream / Event Sync): not device work
            if e.name not in names and "Sync" not in e.name:
                device.append((a, b, e.name))
        else:
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)
            if e.name in LAUNCH_CALLS:
                launches += 1
            elif e.name in names:
                spans.append((a, b, e.name))
    if not device or lo is None:
        return None
    lo, hi = min(lo, min(d[0] for d in device)), max(hi, max(d[1] for d in device))
    busy = _merge([(a, b) for a, b, _ in device])
    by_name = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    gaps, t = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = (a + b) / 2
        inner = [s for s in spans if s[0] <= mid <= s[1]]
        label = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "host"
        labelled.append([label, (b - a) / 1e6])
    return dict(busy_s=sum(b - a for a, b in busy) / 1e6, window_s=(hi - lo) / 1e6, launches=launches,
                device_ops=sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP],
                idle_gaps=labelled)
