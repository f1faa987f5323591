#!/usr/bin/env python3
"""Host cost per call of the port's two most-launched SpMV wrappers (K2's
DIAMatrix.matvec, K8's BellMatrix.matvec) and the warm CG time per
iteration of the P1 and contact paths, on one NVIDIA card.

    python3 path_times.py [--root DIR] [--calls 1000] [--solves 5]

DIR is a checkout of the repository (default: the one holding this
script); its package and its chip_smoke.py build everything, so the same
script measures two commits alike (unpack the other one with `git archive`
into a git-ignored directory, and alternate the two in one call).  It
prints one JSON line per item; the first line is the card's nvidia-smi
name and power limit.

- SpMV wrappers: the P1 fold operator of chip_smoke.make_problem at n=64
  and n=32 (65^3 and 33^3, float32) and the BELL operator of the contact
  problem at NB=24/NT=20 (float32): the host clock per call over `calls`
  back-to-back matvecs with no synchronize (the wrapper's own cost while
  the card keeps up) and the warm CUDA-event time per call over the same
  calls.
- Paths: chip_smoke's P1 main path at n=64 (4-level GMG, Chebyshev 2+2)
  and its contact path (chip_smoke.build_contact: BELL + SA-AMG), each
  solved `solves` times warm (CG, rtol 1e-6, host clock around a solve
  ending in synchronize): ms per iteration of every solve and their
  median, and for the contact path the peak device memory of its build
  and first solve (torch.cuda.max_memory_allocated).

Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def per_call(fn, calls):
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        fn()
    stop.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * host / calls, start.elapsed_time(stop) / calls


def solve_ms_per_it(cg, A, b, M, solves):
    """ms per CG iteration of `solves` warm solves (one unmeasured first)."""
    import torch

    cg(A, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    out = []
    for _ in range(solves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, its, _ = cg(A, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0) / max(its, 1))
    return its, out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--solves", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: these times are taken on a card")
    if Path(dmt.__file__).resolve().parent.parent != root:
        cs.fail(f"imported {dmt.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)

    def emit(**kw):
        print(json.dumps(dict(root=str(root), **kw)), flush=True)

    for m in (64, 32):
        A = cs.make_problem(m, np.float32, dev)[4].assemble()
        x = torch.randn(A.shape[0], device=dev)
        host, warm = per_call(lambda: A.dia.matvec(x), args.calls)
        emit(op=f"DIAMatrix.matvec {A.dia.vshape} f32 (K2)", calls=args.calls, host_ms=host, warm_ms=warm)
    V, bcs, mpc, a, _ = cs.make_contact(cs.NB_CONTACT, cs.NT_CONTACT, np.float64, dev)
    B = bell_from_scipy(dmt.assemble_matrix(a, mpc, bcs).to_scipy(), dtype=np.float32, device=dev)
    x = torch.randn(B.shape[1], device=dev)
    host, warm = per_call(lambda: B.matvec(x), args.calls)
    emit(op=f"BellMatrix.matvec {B.shape} f32 (K8)", calls=args.calls, host_ms=host, warm_ms=warm)
    del B, V, bcs, mpc, a

    # the P1 main path (chip_smoke.main_path's solve, without its checks)
    V, bc, mpc, a, clf = cs.make_problem(cs.N_MAIN, np.float32, dev)
    A = clf.assemble()
    b = dmt.set_bc(dmt.assemble_vector(dmt.LinearForm(V, lambda v, c: 4.0 * v.value), mpc), [bc])
    ops, masks = dmt.build_gmg_hierarchy(lambda m: cs.make_problem(m, np.float32, dev)[4], cs.N_MAIN, 4, min_n=8)
    ops[0] = A
    M = dmt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev", n_pre=2, n_post=2)
    its, ms = solve_ms_per_it(dmt.cg, A.matvec, b, M, args.solves)
    emit(path=f"P1 n={cs.N_MAIN}", its=its, ms_per_it=ms, median_ms_per_it=statistics.median(ms))
    del V, bc, mpc, a, clf, A, b, ops, masks, M

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    built = cs.build_contact(dev)
    b32, B, M = built[4], built[6], built[7]
    dmt.cg(B.matvec, b32, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    its, ms = solve_ms_per_it(dmt.cg, B.matvec, b32, M, args.solves)
    emit(path=f"contact NB={cs.NB_CONTACT}/NT={cs.NT_CONTACT}", its=its, ms_per_it=ms,
         median_ms_per_it=statistics.median(ms), peak_mb=peak / 1e6)


if __name__ == "__main__":
    main()
