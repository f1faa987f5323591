"""The port's spans on the card (dolfinx_mpc_tpu_torch/utils/timing.py):
what they cost and where they sit in the profiler's trace.

    python3 scripts/port_spans.py [--workload CELL ...] [--requests N] [--seed S]

from the root of a checkout, on a machine with a CUDA card.  Prints one
JSON line per item:

- "cost": microseconds per span with no profiler recording (a loop of 10^5
  spans) and with one recording (10^4 spans);
- per cell of the benchmark (portbench, the cell's own size): its set-up
  and warm request, with the trace table then ("after_setup"), then N requests with the benchmark's tracer off, counting the spans and
  counter updates of both tables per request ("per_request"), the ms per
  request, the product of the count and the cost as a share of it, and the
  trace table;
- then two requests under torch.profiler with the benchmark's spans on
  ("nesting"): for each span of the port, how many of its ranges lie
  inside a range of the benchmark (precond, bell_convert, assemble), how
  many kernel launches lie inside its ranges, and the names of any event on
  the device's timeline that carries a span's name (none expected).
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUTER = {"gmg.": "precond", "csr.to_scipy": "bell_convert", "bell.": "bell_convert",
         "~MPC: Assemble": "assemble"}


def span_cost(n):
    """Microseconds per `with span(...)` over n spans, the empty loop's time taken off."""
    from dolfinx_mpc_tpu_torch.utils import timing

    name = "cost.probe"
    t0 = time.perf_counter()
    for _ in range(n):
        with timing.span(name):
            pass
    t1 = time.perf_counter()
    for _ in range(n):
        pass
    t2 = time.perf_counter()
    return 1e6 * ((t1 - t0) - (t2 - t1)) / n


def _calls():
    from dolfinx_mpc_tpu_torch.utils import timing

    return sum(v[0] for v in timing.trace_timings().values()) + sum(v[0] for v in timing.timings().values())


def cell_report(name, seed, requests, us_off, device="cuda"):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from portbench.core import load_cell, load_module
    from portbench.inputs import WARM
    from portbench.trace import LAUNCH_CALLS, Tracer

    from dolfinx_mpc_tpu_torch.utils.timing import reset_timings, trace_timings

    reset_timings()
    cell = load_cell(name)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    tracer = Tracer("off", sync)
    problem = load_module("configs", cell.config).Problem(cell.cfg, cell.traffic, seed, torch.device(device), tracer)
    problem.request(WARM)
    sync()
    print(json.dumps({"cell": name, "item": "after_setup", "trace_timings": trace_timings()}), flush=True)
    c0, t0 = _calls(), time.perf_counter()
    for k in range(requests):
        problem.request(k)
    ms = 1e3 * (time.perf_counter() - t0) / requests
    per_request = (_calls() - c0) / requests
    print(json.dumps({"cell": name, "item": "per_request", "spans": per_request, "ms": ms,
                      "share_pct": 100.0 * per_request * us_off * 1e-3 / ms, "trace_timings": trace_timings()}),
          flush=True)

    tracer.mode = "profile"
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(2):
            problem.request(requests + k)
        sync()
    events = prof.events()
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    launches = [e.time_range.start for e in cpu if e.name in LAUNCH_CALLS]
    ours = sorted({e.name for e in cpu if any(e.name.startswith(p) for p in OUTER)})
    out = {}
    for span in ours:
        outer = next(v for p, v in OUTER.items() if span.startswith(p))
        ranges = [e.time_range for e in cpu if e.name == span]
        around = [e.time_range for e in cpu if e.name == outer]
        inside = sum(any(a.start <= r.start and r.end <= a.end for a in around) for r in ranges)
        kernels = sum(any(r.start <= t <= r.end for r in ranges) for t in launches)
        out[span] = {"ranges": len(ranges), "inside_" + outer: inside, "launches_inside": kernels}
    on_device = sorted({e.name for e in events if e.device_type == DeviceType.CUDA and e.name in ours})
    print(json.dumps({"cell": name, "item": "nesting", "spans": out, "launches": len(launches),
                      "span_names_on_device": on_device}), flush=True)
    del problem
    if device == "cuda":
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", nargs="*", default=["p1_n216.solve", "contact_74k.newton"])
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 101)
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from dolfinx_mpc_tpu_torch._build import load_kernels

    load_kernels()
    off = [span_cost(100_000) for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = span_cost(10_000)
    print(json.dumps({"item": "cost", "card": torch.cuda.get_device_name(0), "us_per_span_off": off,
                      "us_per_span_profiling": on}), flush=True)
    for name in args.workload:
        cell_report(name, args.seed, args.requests, statistics.median(off))
    return 0


if __name__ == "__main__":
    sys.exit(main())
