#!/usr/bin/env python3
"""Does index_add_ on complex CUDA tensors take the atomic path the real one
takes?  One JSON line per dtype.

    python3 scripts/index_add_complex_probe.py [--rows 8000] [--entries 171000] [--reps 20]

The shape is the "csr" side product of chip_smoke.py's 11a / 12a at P1 n=64
(about 171,000 products added into about 8,000 slave-adjacent rows): for
float32, float64, complex64 and complex128 the script adds the same
numpy-seeded values at the same numpy-seeded rows `--reps` times and reports
how many bitwise-distinct results the repetitions gave (more than one: the
order of the additions changes from run to run, as atomics make it), the
device time per call (CUDA events, warm), and the CUDA kernels
torch.profiler records for one call with their device time.  Needs a card.
"""

import argparse
import json

import numpy as np
import torch


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows", type=int, default=8000)
    p.add_argument("--entries", type=int, default=171000)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    rows = torch.as_tensor(rng.integers(0, args.rows, args.entries), device=dev)
    re, im = rng.standard_normal(args.entries), rng.standard_normal(args.entries)
    for dt in (torch.float32, torch.float64, torch.complex64, torch.complex128):
        vals = torch.as_tensor(re + 1j * im if dt.is_complex else re, device=dev).to(dt)
        outs = set()
        for _ in range(args.reps):
            y = torch.zeros(args.rows, dtype=dt, device=dev).index_add_(0, rows, vals)
            outs.add(y.cpu().numpy().tobytes())
        fn = lambda: torch.zeros(args.rows, dtype=dt, device=dev).index_add_(0, rows, vals)  # noqa: E731
        for _ in range(3):
            fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(100):
            fn()
        stop.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {e.key[:90]: round(e.self_device_time_total / max(e.count, 1) / 1e3, 5)
                   for e in prof.key_averages() if e.device_type.name == "CUDA"}
        print(json.dumps({"dtype": str(dt)[6:], "distinct_results": len(outs), "reps": args.reps,
                          "ms_per_call": start.elapsed_time(stop) / 100, "kernels_ms": kernels,
                          "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
