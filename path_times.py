#!/usr/bin/env python3
"""Host cost per call of the port's kernel wrappers (K2's and K7's
DIAMatrix.matvec, K6's BlockDIAMatrix.matvec_blocked, K8's
BellMatrix.matvec, the assemblers K1, K4, K3 and K5), bench.py's assembly
throughput and the warm CG time per iteration of the P1, bs=3, P2 and
contact paths, on one NVIDIA card.

    python3 path_times.py [--root DIR] [--items spmv,asm,paths] [--calls 1000] [--solves 5]

DIR is a checkout of the repository (default: the one holding this
script); its package builds and runs everything, with the problem set-up
of the chip_smoke.py beside this script, so the same script measures two
commits alike (unpack the other one with `git archive` into a git-ignored
directory, and alternate the two in one call: parent, change, change,
parent).  It prints one JSON line per item; the first line is the card's
nvidia-smi name and power limit.

- spmv: the P1 fold operator of chip_smoke.make_problem at n=64
  and n=32 (65^3 and 33^3, float32, K2), the bs=3 operator of
  chip_smoke.make_elasticity at n=64 and n=32 (K7), the P2 operator at
  n=64 on its class stack (8 x 65^3, K6) and the BELL operator of the
  contact problem at NB=24/NT=20 (K8): the host clock per call over
  `calls` back-to-back matvecs with no synchronize (the wrapper's own cost
  while the card keeps up) and the warm CUDA-event time per call over the
  same calls.
- asm: the assemblers' wrappers on the n=64 tables, float32 (K1 on P1
  15 x 65^3 and on bs=3 135 x 65^3, K4 on P2 230 x 65^3, K3 on P1 and P2
  with chip_smoke.blob's non-separable set; K5 on the raw tables of the
  bs=3 form, 135 x 65^3, and of the P2 form, blocked 230 x 65^3 and
  refined 65 x 129^3), the same two times over 200 calls (their launches
  outlast their host cost, so fewer calls keep the launch queue from
  filling); then bench.py's constrained-assembly metric
  for the P1, P2 and bs=3 problems at n=64 (chip_smoke.assembly_rate: ms
  per whole clf._assemble_fold_lean_kernel call, MDoF/s, GB/s of operator
  data written).
- paths: chip_smoke's P1 main path at n=64 (4-level GMG, Chebyshev 2+2),
  its bs=3 path at n=64 (chip_smoke.build_bs3: 4-level GMG, Chebyshev
  3+3), its P2 path at n=64 (chip_smoke.build_p2: blocked_io GMG over the
  p-coarsened levels, CG on the class stack) and its contact path
  (chip_smoke.build_contact: BELL + SA-AMG), each solved `solves` times
  warm (CG, rtol 1e-6, host clock around a solve ending in synchronize):
  ms per iteration of every solve and their median, and for the contact
  path the peak device memory of its build and first solve
  (torch.cuda.max_memory_allocated).

Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
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
    ap.add_argument("--items", default="spmv,asm,paths")
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--solves", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    items = set(args.items.split(","))
    sys.path.insert(0, str(root))
    import torch

    # the problem set-up beside this script, over DIR's package
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import dolfinx_mpc_tpu_torch as dmt

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: these times are taken on a card")
    if Path(dmt.__file__).resolve().parent.parent != root:
        cs.fail(f"imported {dmt.__file__}, not the package under {root}")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)

    def emit(**kw):
        print(json.dumps(dict(root=str(root), **kw)), flush=True)

    def wrapper_times(label, x, mv, calls=args.calls):
        host, warm = per_call(lambda: mv(x), calls)
        emit(op=f"{label} f32", calls=calls, host_ms=host, warm_ms=warm)

    if "spmv" in items:
        spmv_wrappers(cs, dmt, dev, wrapper_times)
    if "asm" in items:
        asm_times(cs, dev, wrapper_times, emit)
    if "paths" in items:
        path_solves(cs, dmt, dev, args, emit)


def spmv_wrappers(cs, dmt, dev, wrapper_times):
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy

    for m in (64, 32):
        A = cs.make_problem(m, np.float32, dev)[4].assemble()
        wrapper_times(f"DIAMatrix.matvec {A.dia.vshape} (K2)", torch.randn(A.shape[0], device=dev), A.dia.matvec)
    for m in (64, 32):
        A = cs.make_elasticity(m, np.float32, dev)[4].assemble()
        wrapper_times(f"DIAMatrix.matvec {A.dia.vshape} bs=3 (K7)", torch.randn(A.shape[0], device=dev),
                      A.dia.matvec)
    A = cs.make_problem(64, np.float32, dev, degree=2)[4].assemble()
    xb = A.dia.to_blocked(torch.randn(A.shape[0], device=dev)).contiguous()
    wrapper_times(f"BlockDIAMatrix.matvec_blocked {tuple(xb.shape)} (K6)", xb, A.dia.matvec_blocked)
    del A, xb
    V, bcs, mpc, a, _ = cs.make_contact(cs.NB_CONTACT, cs.NT_CONTACT, np.float64, dev)
    B = bell_from_scipy(dmt.assemble_matrix(a, mpc, bcs).to_scipy(), dtype=np.float32, device=dev)
    wrapper_times(f"BellMatrix.matvec {B.shape} (K8)", torch.randn(B.shape[1], device=dev), B.matvec)
    del B, V, bcs, mpc, a


def asm_times(cs, dev, wrapper_times, emit, n=64):
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

    for label, make, kernel in (
            ("K1 P1", lambda: cs.make_problem(n, np.float32, dev)[4], LK.assemble_fold_lean_factored),
            ("K1 bs=3", lambda: cs.make_elasticity(n, np.float32, dev)[4], LK.assemble_fold_lean_factored),
            ("K4 P2", lambda: cs.make_problem(n, np.float32, dev, degree=2)[4], LK.assemble_fold_lean_blocked),
            ("K3 P1", lambda: cs.make_problem(n, np.float32, dev, marker=cs.blob)[4], LK.assemble_fold_lean_masked),
            ("K3 P2", lambda: cs.make_problem(n, np.float32, dev, degree=2, marker=cs.blob)[4],
             LK.assemble_fold_lean_masked)):
        clf = make()
        tab = clf.table.on(dev, torch.float32)
        wrapper_times(f"{kernel.__name__} {label[3:]} {(tab.n_planes,) + tuple(tab.vshape)} ({label[:2]})", 0.013,
                      lambda j: kernel(tab, j, 1.0), calls=200)
        if label[:2] != "K3":
            ms, nbytes = cs.assembly_rate(clf)
            dofs = clf.V.num_dofs
            emit(path=f"{label[3:]} n={n}", assembly_ms=ms, mdof_s=dofs / ms / 1e3, gb_s=nbytes / ms / 1e6,
                 dofs=dofs, bytes=nbytes)
        del clf, tab
        torch.cuda.empty_cache()
    # K5 on the raw (unmasked) tables of the bs=3 and P2 forms
    el = cs.make_elasticity(n, np.float32, dev)[4]
    p2 = cs.make_problem(n, np.float32, dev, degree=2)[4]
    for label, table in (("bs=3 grid", LK.build_fold_table(el)), ("P2 blocked", LK.build_fold_table(p2)),
                         ("P2 refined r=2", LK.build_fold_table(p2, _refined=True))):
        tab = table.on(dev, torch.float32)
        wrapper_times(f"assemble_fold_lean_raw {label} {(tab.n_planes,) + tuple(tab.vshape)} (K5)", 0.013,
                      lambda j: LK.assemble_fold_lean_raw(tab, j), calls=200)
        del tab
        table._on.clear()
        torch.cuda.empty_cache()
    del el, p2


def path_solves(cs, dmt, dev, args, emit):
    import numpy as np
    import torch

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
    for name, build, n in (("bs=3", cs.build_bs3, cs.N_BS3), ("P2", cs.build_p2, cs.N_P2)):
        built = build(dev, n)
        A, b, M = built[3], built[4], built[7]
        mv, rhs = (A.matvec_blocked, A.to_blocked(b)) if name == "P2" else (A.matvec, b)
        its, ms = solve_ms_per_it(dmt.cg, mv, rhs, M, args.solves)
        emit(path=f"{name} n={n}", its=its, ms_per_it=ms, median_ms_per_it=statistics.median(ms))
        del built, A, b, M, mv, rhs

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
