#!/usr/bin/env python3
"""Profile the P2 path's (or the bs=3 path's, or the contact path's) fine
SpMV, assembler, SpMV kernel, V-cycle and preconditioned CG solve on one
NVIDIA card with torch.profiler.

    python3 profile_p2.py [--n 64] [--path p2|bs3|contact]

Run from the repository root.  It builds chip_smoke.py's P2 problem at n
(bench.py's degree-2 problem, float32, six p-coarsened levels at n=64,
blocked_io GMG: K4, K6) or, with --path bs3, its bs=3 problem (bench.py's
BENCH_BS=3 elasticity, float32, four levels, Chebyshev 3+3: K1 at bs=3,
K7), or, with --path contact, its contact problem (bench_contact_3D.py
--format bell --pc amg at NB=24/NT=20, float32 BELL operator and SA-AMG:
K8; the "assembler" region is the general slot-CSR assembler in float64,
n is ignored), warms every region, then for each region prints one JSON
line: the host-clock wall per call with and without the profiler, the
device (kernel) time per call, kernels per call, the device busy share
against both walls, and the eight largest kernels.  The unprofiled wall is
taken in the same process just before the profiled one.  The first line is
the card's nvidia-smi name and power limit, the last its SM clock and
power draw.  Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke as cs  # noqa: E402


def region(name, fn, reps):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.time() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_prof = (time.time() - t0) / reps
    kern = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_ms = sum(e.self_device_time_total for e in kern) / reps / 1e3
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    print(json.dumps(dict(
        region=name, reps=reps, wall_ms=wall * 1e3, wall_profiled_ms=wall_prof * 1e3, device_ms=dev_ms,
        kernels=sum(e.count for e in kern) / reps, busy=dev_ms / (wall * 1e3),
        busy_profiled=dev_ms / (wall_prof * 1e3),
        top=[(e.key[:60], e.count / reps, e.self_device_time_total / reps / 1e3) for e in top])), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=cs.N_P2)
    ap.add_argument("--path", choices=("p2", "bs3", "contact"), default="p2")
    args = ap.parse_args()
    n = args.n
    import torch

    import dolfinx_mpc_tpu_torch as dmt

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: profiling needs a CUDA card")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    if args.path == "p2":
        V, _, clf, A, b, ops, _, M, _, _ = cs.build_p2(dev, n)
        bb = A.dia._to_blocked(b)
        mv, mv_kernel, names = A.matvec_blocked, A.dia.matvec_blocked, ("K6", "K4")
        assemble, levels = clf.assemble, [o.dia.vshape for o in ops]
    elif args.path == "bs3":
        V, _, clf, A, bb, ops, _, M, _, _ = cs.build_bs3(dev, n)
        mv, mv_kernel, names = A.matvec, A.dia.matvec, ("K7", "K1")
        assemble, levels = clf.assemble, [o.dia.vshape for o in ops]
    else:
        from dolfinx_mpc_tpu_torch.la.bell import bell_matvec

        V, mpc, a, bcs, bb, _, B, M, _, _, _, _ = cs.build_contact(dev)
        mv, names = B.matvec, ("K8", "assemble_matrix")
        mv_kernel = lambda x: bell_matvec(B.data, B.cols, x, B.shape[0])  # noqa: E731
        assemble, levels = (lambda: dmt.assemble_matrix(a, mpc, bcs)), [o.shape for o in M.ops]
    xr = bb / torch.linalg.vector_norm(bb)

    def solve():
        return dmt.cg(mv, bb, M=M, rtol=1e-6, atol=1e-12, max_it=3000)

    for _ in range(3):
        mv(xr)
        M(xr)
        its = solve()[1]
    print(json.dumps(dict(path=args.path, n=n, dofs=V.num_dofs, levels=levels, cg_its=its)), flush=True)
    region("fine matvec", lambda: mv(xr), 20)
    region(f"{names[0]} alone", lambda: mv_kernel(xr), 20)
    region(f"{names[1]} alone", assemble, 5)
    region("V-cycle", lambda: M(xr), 5)
    region("CG solve", solve, 2)
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(res.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
