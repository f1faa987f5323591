#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root (no arguments, one card).  Phases, one line
each (or a few), any failure exits non-zero:

1. the card: torch.cuda.is_available() must hold (there is no CPU path);
   name and power limit from nvidia-smi;
2. build the CUDA kernels (csrc/lattice_kernels.cu, nvcc -> ctypes);
3. each kernel against its plain PyTorch version on the card, at the paths'
   shapes, in float32 and float64, with CUDA-event times: K1 and K2 on the
   P1 n=64 operator and on P1 n=128 (the P2 path's level 1; K2 also at
   n=32), K4 on the P2 n=64 blocked table, K6 on
   that operator, K3 on P1 65^3 and P2 n=64 with a non-separable Dirichlet
   set (the y-planes and a ball on the y=0 face); K1 at bs=3 (135 x 65^3),
   K7 on the bs=3 grids 65^3 and 33^3, and K5 on the raw bs=3 grid table
   (135 x 65^3), the raw blocked P2 n=64 table (230 x 65^3) and the refined
   r=2 P2 n=64 table (65 x 129^3), where K5 must also equal K1 / K4 with
   unit mask factors bit for bit;
4. the P1 main path: the default problem of bench.py (P1 tets, n=64,
   274,625 dofs, periodic in x, Dirichlet at y=0/1), float32 on the card,
   through the port's entry points: assemble_matrix_lattice (fold) ->
   assemble_vector + set_bc -> 4-level GMG (Chebyshev smoother) -> cg ->
   backsubstitution, with the kernel launch counters reset just before and
   read just after;
4b. the P2 main path: bench.py's degree-2 problem (P2 tets, n=64, 2,146,689
   dofs, same constraints, quad_degree=2), float32:
   assemble_matrix_lattice (K4) -> manufactured b = A u0 -> the six-level
   p-coarsened hierarchy -> LatticeGMG(blocked_io=True) -> cg on the class
   stack -> backsubstitution, counters reset before and read after; then
   the same at n=32, the size whose CG count the JAX package gives on the
   CPU;
4c. the bs=3 path: bench.py's BENCH_BS=3 problem (P1 vector tets, n=64,
   823,875 dofs, same constraints with the bc value np.zeros(3), linear
   elasticity with mu=1, lambda=1.25, quad_degree=1), float32:
   assemble_matrix_lattice (K1 at bs=3) -> manufactured b = A u0 -> 4-level
   GMG (Chebyshev 3+3) -> cg -> backsubstitution, counters reset before and
   read after (K1 and K7 launched, K2 not at all); then the same at n=32;
5. the float64 oracles on the card: LinearProblem (Jacobi-CG) against
   u = K (K^T A K)^-1 K^T b from scipy at P1 n=6, at P2 n=3, at P1 n=6
   with the non-separable set (the path of K3), at bs=3 P1 n=4 with a vector
   source (K1, K7), and for the reaction-diffusion form without Dirichlet
   dofs at P1 n=6 (K5, K2) and P2 n=3 (K5, K6), counters reset before each.

The last two lines are the card's nvidia-smi line and
{"ok": true, "device": {...}}; the line before them lists every kernel
(K1-K7) with its launches on its path, its error against the plain version
and both times.  Nothing here imports JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_MAIN = 64
# CG iterations of the JAX package on the same float32 problem on the CPU
# (XLA path; the TPU record of 11 is context, not the gate): 12, rnorm
# 6.02e-09 at |b| = 7.72e-03, measured with
#   JAX_PLATFORMS=cpu python - <<'EOF'
#   import jax; jax.config.update("jax_platforms", "cpu")
#   import numpy as np, jax.numpy as jnp, dolfinx_mpc_tpu as dmt
#   from dolfinx_mpc_tpu.fem.forms import grad, inner
#   from dolfinx_mpc_tpu.fem.mesh import create_unit_cube
#   from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice
#   from dolfinx_mpc_tpu.la.gmg import LatticeGMG, build_gmg_hierarchy
#   from dolfinx_mpc_tpu.la.solvers import cg
#   def make(m):  # bench.py make_problem, P1 scalar
#       V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
#       bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(
#           V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
#       mpc = dmt.MultiPointConstraint(V, dtype=np.float32)
#       mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
#           lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
#       mpc.finalize()
#       a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
#       return V, bc, mpc, assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=np.float32,
#                                                 side_format="fold")
#   V, bc, mpc, clf = make(64); A = clf.assemble()
#   b = dmt.set_bc(dmt.assemble_vector(dmt.LinearForm(V, lambda v, c: 4.0 * v.value),
#                                      mpc, dtype=np.float32), [bc])
#   ops, masks = build_gmg_hierarchy(lambda m: make(m)[3], 64, 4, min_n=8); ops[0] = A
#   M = LatticeGMG(ops, free_masks=masks, smoother="chebyshev", n_pre=2, n_post=2)
#   print(jax.jit(lambda A_, M_, b_: cg(A_.matvec, b_, M=M_, rtol=1e-6, atol=1e-12,
#                                       max_it=3000))(A, M, b)[1:])
#   EOF
JAX_CPU_CG_ITS = 12
# Residual gates on the float32 solution x, recomputed in float64 with the
# plain SpMV.  b is O(h^3) (|b|_inf 1.5e-5 at n=64) while A x sums terms of
# O(|A| |x|) ~ 0.5, so the float32 rounding of x alone puts |b - A x| far
# above 1e-6 |b| (measured on the CPU: 9.5e-6 |b| at n=16, 3.7e-5 |b| at
# n=32, growing with the condition number); 1e-6 is therefore held against
# the normwise backward error |b - A x|_inf / (|A|_inf |x|_inf + |b|_inf)
# (8.5e-8 at n=16, 4.1e-8 at n=32), and x must agree with a float64 solve of
# the same system to 1e-4, the eps32 * cond(A) bound at n=64 (2.0e-6
# measured at n=32).
BACKWARD_ERROR_GATE = 1e-6
FORWARD_ERROR_GATE = 1e-4
# CG iterations of the JAX package on the P2 float32 problem on the CPU
# (XLA path, blocked_io GMG over the p-coarsened levels, manufactured
# b = A u0): 8, rnorm 6.61e-07 at |b| 1.58, at n=32, measured with the
# same recipe as above through bench.py's degree-2 branch:
#   make(lv): deg, m = lv; as make(m) above with ("Lagrange", deg) and
#       quad_degree=deg
#   clf = make((2, 32)); A = clf.assemble(); u0 = bench.py:509-514 on
#   clf.vshape; b = A.matvec(u0)
#   levels = [(2, 32), (1, 64), (1, 32), (1, 16), (1, 8)]  (bench.py:545-550)
#   ops, masks = build_gmg_hierarchy(make, 32, 0, levels=levels); ops[0] = A
#   M = LatticeGMG(ops, free_masks=masks, blocked_io=True, smoother="chebyshev",
#                  n_pre=2, n_post=2)
#   cg(A.matvec_blocked, A.dia._to_blocked(b), M=M, rtol=1e-6, atol=1e-12,
#      max_it=3000)  (jitted, as bench.py:656-659)
# n=64 was not run through the JAX package on a shared CPU host (the
# full-size configuration; n=32 already holds 1.4 GB).  The n=32 count
# gates both the n=32 run and, GMG's count being nearly independent of n
# (the TPU record at n=64 is 9), the n=64 main path.
JAX_CPU_P2_CG_ITS = 8
N_P2 = 64
N_P2_JAX = 32
# CG iterations of the JAX package on bench.py's BENCH_BS=3 float32 problem
# on the CPU (XLA path; manufactured b = A u0 as bench.py:504-515; 4-level
# GMG down to 9^3, Chebyshev 3+3, dense coarse inverse; rtol 1e-6, atol
# 1e-12), with the recipe above and, per level,
#   V = functionspace(create_unit_cube(m, m, m), ("Lagrange", 1, (3,)))
#   bc = dirichletbc(np.zeros(3), <y-planes>, V)
#   a = BilinearForm(V, lambda u, v, c: 2 * inner(sym(grad(u)), sym(grad(v)))
#                    + 1.25 * div(u) * conj(div(v)), quad_degree=1)
#   ops, masks = build_gmg_hierarchy(make, n, 4, min_n=8); ops[0] = A
#   M = LatticeGMG(ops, free_masks=masks, smoother="chebyshev", n_pre=3, n_post=3)
# n=32: 15 its, rnorm 2.10e-06 at |b| 2.85 (n=16: 10); the port gives the
# same counts on the CPU.  n=64: 21 its, from the same recipe on a CPU host
# (the full-size configuration, not rerun with this script's port).  The
# TPU records (21 in r4, 32 in r5b, an XLA:TPU fusion precision defect,
# benchmarks/RESULTS.md:113-123) are not the gate.
JAX_CPU_BS3_CG_ITS = {64: 21, 32: 15}
N_BS3 = 64


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def ptxas_summary(log):
    """'kernel<type> registers, spill bytes' per kernel from the -Xptxas -v
    report that the build keeps beside the library."""
    import re

    out, name, spill = [], None, "?"
    for ln in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"(fold_assemble_masked|fold_assemble_raw|fold_assemble|dia_matvec_bs|dia_matvec|"
                      r"blocked_matvec)_kernelI([fd])(?:Li(\d)E)?E", ln)
        if m and "Compiling entry function" in ln:
            name = (f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                    f"{', ' + m.group(3) if m.group(3) else ''}>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs, spill st/ld {spill} B")
            name, spill = None, "?"
    return "; ".join(out) or "no ptxas report"


def cuda_ms(fn, reps, warmup=3):
    """Mean device time of fn() in ms over `reps` back-to-back calls
    (CUDA events; operands stay warm in the 50 MB L2, as they do inside one
    CG iteration at n=64)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def y_planes(x):
    import numpy as np

    return np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)


def blob(x):
    """A non-separable Dirichlet set: the y-planes and a ball about
    (0.5, 0, 0.5).  It keeps clear of the periodic planes x=0/1: a Dirichlet
    master (the corner blob x+y+z < 0.35 has three at n=6) makes both
    packages' LinearProblem differ from the K (K^T A K)^-1 K^T b oracle by
    7.5e-3, as ROADMAP queue 3 records."""
    return y_planes(x) | ((x[0] - 0.5) ** 2 + x[1] ** 2 + (x[2] - 0.5) ** 2 < 0.35 ** 2)


def make_problem(m, dtype, device, degree=1, marker=y_planes):
    """bench.py's make_problem for scalar Poisson, through the port."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", degree))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, marker), V)
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=degree)
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold",
                                      device=device)
    return V, bc, mpc, a, clf


def make_elasticity(m, dtype, device):
    """bench.py's make_problem for BENCH_BS=3 (the reference's
    bench_elasticity_edge), through the port: P1 vector tets, periodic in x,
    Dirichlet np.zeros(3) on the y-planes, 2 mu sym(grad u):sym(grad v) +
    lambda div u div v with mu = 1, lambda = 1.25."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1, (3,)))
    bc = dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, y_planes), V)
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    mu, lam = 1.0, 1.25
    a = dmt.BilinearForm(V, lambda u, v, c: 2 * mu * inner(sym(grad(u)), sym(grad(v)))
                         + lam * div(u) * conj(div(v)), quad_degree=1)
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold",
                                      device=device)
    return V, bc, mpc, a, clf


def make_free(m, dtype, device, degree=1):
    """The reaction-diffusion form inner(grad u, grad v) + 0.5 inner(u, v)
    of tests/test_pallas_lattice.py:114-118 without Dirichlet dofs,
    periodic in x: the forms that assemble through K5."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", degree))
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)) + 0.5 * inner(u, v),
                         quad_degree=degree + 1)
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[], dtype=dtype, side_format="fold", device=device)
    return V, None, mpc, a, clf


def manufactured_u0(clf, device):
    """bench.py:504-515's u0 for the manufactured right-hand side b = A u0:
    sin(pi i/n0) sin(pi j/n1) sin(2 pi k/n2) times keep, components
    interleaved (float32)."""
    import numpy as np
    import torch

    n0, n1, n2 = clf.vshape
    ax = [torch.arange(m, dtype=torch.float32, device=device) / m for m in (n0, n1, n2)]
    pat = (torch.sin(np.pi * ax[0])[:, None, None] * torch.sin(np.pi * ax[1])[None, :, None]
           * torch.sin(2 * np.pi * ax[2])[None, None, :])
    keep = torch.as_tensor(clf._keep_grid, device=device)  # (bs, n0, n1, n2)
    return torch.movedim(pat[None] * keep, 0, -1).reshape(-1)


def cast_operator(A, dtype, absolute=False, dia_types=None):
    """The fold operator A with its data cast to `dtype` (and made entrywise
    absolute, diagval too), over dia_types = (scalar DIA class, block-DIA
    class): the package's own by default, whose SpMV is K2 / K6 on the card."""
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, DIAMatrix, LatticeOperator

    dia_t, block_t = dia_types or (DIAMatrix, BlockDIAMatrix)
    data = A.dia.data.to(dtype)
    if absolute:
        data = data.abs()
    dv = abs(A.diagval) if absolute else A.diagval
    if isinstance(A.dia, BlockDIAMatrix):
        dia = block_t(data, A.dia.trips, A.dia.vshape, A.dia.r3)
    else:
        dia = dia_t(data, A.dia.offsets, A.dia.vshape, A.dia.bs)
    return LatticeOperator(dia, dv, A.fold_axis, A.fold_mask, A.fold_pairs, fold_mask_b=A.fold_mask_b)


def plain_operator(A, dtype, absolute=False):
    """cast_operator with the plain PyTorch SpMV in place of K2 / K6."""
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, DIAMatrix
    from dolfinx_mpc_tpu_torch.ops.lattice_kernels import blocked_matvec_plain, dia_matvec_plain

    class PlainDIA(DIAMatrix):
        def matvec(self, x):
            return dia_matvec_plain(self.data, self.offsets, self.vshape, self.bs, x)

    class PlainBlockDIA(BlockDIAMatrix):
        def matvec_blocked(self, xb):
            return blocked_matvec_plain(self.data, self.trips, self.classes, xb)

    return cast_operator(A, dtype, absolute, (PlainDIA, PlainBlockDIA))


def error_gates(A, b, x, x_ref):
    """(backward error, |b - A x| / |b|, forward error) of the float32
    solution x (flat) of A x = b, recomputed in float64 with the plain
    SpMV; x_ref is a float64 solution of the same system."""
    import torch

    A64 = plain_operator(A, torch.float64)
    b64, x64 = b.double(), x.double()
    r = b64 - A64.matvec(x64)
    a_inf = float(plain_operator(A, torch.float64, absolute=True).matvec(torch.ones_like(b64)).max())
    eta = float(r.abs().max()) / (a_inf * float(x64.abs().max()) + float(b64.abs().max()))
    rel = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
    fwd = float(torch.linalg.vector_norm(x64 - x_ref) / torch.linalg.vector_norm(x_ref))
    return eta, rel, fwd


def reset_counts():
    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

    for k in KERNELS.values():
        getattr(LK, k).launches = 0


def read_counts(names):
    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

    return {n: getattr(LK, KERNELS[n]).launches for n in names}


# kernel id -> wrapper in ops/lattice_kernels.py
KERNELS = {"K1": "assemble_fold_lean_factored", "K2": "dia_matvec", "K3": "assemble_fold_lean_masked",
           "K4": "assemble_fold_lean_blocked", "K5": "assemble_fold_lean_raw", "K6": "blocked_matvec",
           "K7": "dia_matvec_bs"}


def compare_kernels(dev, gen):
    """Phase 3: K1 and K2 against their plain versions on the card, on the
    P1 main path's fine level (65^3; K2 also on its level 1, 33^3) and on
    the P2 path's level 1 (P1 at n = 2 N_P2, 129^3: their largest shapes).
    Returns the P1 main path's numbers for the kernels line."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

    out = {}
    for m, k1 in ((N_MAIN, True), (2 * N_P2, True), (N_MAIN // 2, False)):
        clf = make_problem(m, np.float32, dev)[4]
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)) if k1 else ():
            tab = clf.table.on(dev, dt)
            got = LK.assemble_fold_lean_factored(tab, 0.013, 1.0)
            ref = LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0)
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            line = f"K1 {str(dt)[6:]} {tuple(got.shape)}: max|d|/max|ref| {rel:.3e} (tol {tol:g})"
            if dt == torch.float32:
                ms = cuda_ms(lambda: LK.assemble_fold_lean_factored(tab, 0.013, 1.0), 50)
                plain_ms = cuda_ms(lambda: LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0), 5, 1)
                if m == N_MAIN:
                    out["K1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K1 disagrees with its plain version in {dt} at {tab.vshape}: {rel:.3e} > {tol:g}")
            del got, ref
        dia = clf.assemble().dia
        n = dia.shape[0]
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-13)):
            data = dia.data.to(dt).contiguous()
            x = torch.randn(n, generator=gen, device=dev, dtype=torch.float64).to(dt)
            got = LK.dia_matvec(data, dia.offsets, dia.vshape, x)
            ref = LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 1, x)
            rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
            line = f"K2 {str(dt)[6:]} {dia.vshape}: rel L2 {rel:.3e} (tol {tol:g})"
            if dt == torch.float32:
                ms = cuda_ms(lambda: LK.dia_matvec(data, dia.offsets, dia.vshape, x), 200)
                plain_ms = cuda_ms(lambda: LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 1, x), 20)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                if m == N_MAIN:
                    out["K2"] = dict(max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms)
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K2 disagrees with its plain version in {dt} at {dia.vshape}: {rel:.3e} > {tol:g}")
        del clf, dia, data
    return out


def compare_blocked_kernels(dev, gen):
    """Phase 3, slice 2: K4 and K6 on the P2 n=64 operator and K3 with the
    non-separable set on P1 65^3 and P2 n=64, against their plain versions
    on the card."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

    out = {}
    clf = make_problem(N_P2, np.float32, dev, degree=2)[4]
    cid = {c: i for i, c in enumerate(clf._classes)}
    real = torch.as_tensor(clf._split_classes(np.ones(clf.vshape)), device=dev)
    real_rows = real[[cid[cr] for cr, _, _ in clf.trips]] != 0  # (n_trip, s0, s1, s2)
    for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
        tab = clf.table.on(dev, dt)
        got = LK.assemble_fold_lean_blocked(tab, 0.013, 1.0)
        ref = LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        pad_nz = int((got[~real_rows] != 0).sum())
        line = (f"K4 {str(dt)[6:]} {tuple(got.shape)}: max|d|/max|ref| {rel:.3e} (tol {tol:g}), "
                f"nonzero padded slots {pad_nz}")
        if dt == torch.float32:
            ms = cuda_ms(lambda: LK.assemble_fold_lean_blocked(tab, 0.013, 1.0), 20)
            plain_ms = cuda_ms(lambda: LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0), 2, 1)
            out["K4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        print(line, flush=True)
        if not rel <= tol or pad_nz:
            fail(f"K4 disagrees with its plain version in {dt}: {rel:.3e} > {tol:g} or {pad_nz} padded values")
        del got, ref
    dia = clf.assemble().dia
    table = torch.as_tensor(LK.blocked_trip_table(dia.trips, dia.classes), device=dev)
    for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-13)):
        data = dia.data.to(dt).contiguous()
        x = torch.randn(dia.shape[0], generator=gen, device=dev, dtype=torch.float64).to(dt)
        xb = dia._to_blocked(x).contiguous()
        got = LK.blocked_matvec(data, dia.trips, dia.classes, xb, table)
        ref = LK.blocked_matvec_plain(data, dia.trips, dia.classes, xb)
        rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
        line = f"K6 {str(dt)[6:]} {tuple(xb.shape)}: rel L2 {rel:.3e} (tol {tol:g})"
        if dt == torch.float32:
            ms = cuda_ms(lambda: LK.blocked_matvec(data, dia.trips, dia.classes, xb, table), 100)
            plain_ms = cuda_ms(lambda: LK.blocked_matvec_plain(data, dia.trips, dia.classes, xb), 10)
            out["K6"] = dict(max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        print(line, flush=True)
        if not rel <= tol:
            fail(f"K6 disagrees with its plain version in {dt}: {rel:.3e} > {tol:g}")
    del clf, dia, data
    for degree in (1, 2):
        clf = make_problem(N_P2, np.float32, dev, degree=degree, marker=blob)[4]
        if clf.table.factors is not None:
            fail("the blob Dirichlet set was taken as separable")
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
            tab = clf.table.on(dev, dt)
            got = LK.assemble_fold_lean_masked(tab, 0.013, 1.0)
            ref = LK.assemble_fold_lean_masked_plain(tab, 0.013, 1.0)
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            line = f"K3 P{degree} {str(dt)[6:]} {tuple(got.shape)}: max|d|/max|ref| {rel:.3e} (tol {tol:g})"
            if dt == torch.float32:
                ms = cuda_ms(lambda: LK.assemble_fold_lean_masked(tab, 0.013, 1.0), 20)
                plain_ms = cuda_ms(lambda: LK.assemble_fold_lean_masked_plain(tab, 0.013, 1.0), 2, 1)
                if degree == 2:
                    out["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K3 disagrees with its plain version in {dt} at degree {degree}: {rel:.3e} > {tol:g}")
            del got, ref
    return out


def compare_elasticity_kernels(dev, gen, n=N_BS3, n_p2=N_P2):
    """Phase 3, slice 3: K1 at bs=3 on the bs=3 path's fine table, K7 on its
    fine level and level 1, and K5 on three raw tables (the bs=3 grid table,
    the blocked P2 n_p2 table and the refined r=2 P2 n_p2 table), each
    against its plain version on the card; K5 must also equal K1 / K4 with
    unit mask factors bit for bit."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

    out = {}
    clf = make_elasticity(n, np.float32, dev)[4]
    for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
        tab = clf.table.on(dev, dt)
        got = LK.assemble_fold_lean_factored(tab, 0.013, 1.0)
        ref = LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0)
        rel = float((got - ref).abs().max()) / float(ref.abs().max())
        line = f"K1 bs=3 {str(dt)[6:]} {tuple(got.shape)}: max|d|/max|ref| {rel:.3e} (tol {tol:g})"
        if dt == torch.float32:
            ms = cuda_ms(lambda: LK.assemble_fold_lean_factored(tab, 0.013, 1.0), 20)
            plain_ms = cuda_ms(lambda: LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0), 2, 1)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        print(line, flush=True)
        if not rel <= tol:
            fail(f"K1 at bs=3 disagrees with its plain version in {dt}: {rel:.3e} > {tol:g}")
        del got, ref
    for m in (n, n // 2):
        dia = (clf if m == n else make_elasticity(m, np.float32, dev)[4]).assemble().dia
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-13)):
            data = dia.data.to(dt).contiguous()
            x = torch.randn(dia.shape[0], generator=gen, device=dev, dtype=torch.float64).to(dt)
            got = LK.dia_matvec_bs(data, dia.offsets, dia.vshape, 3, x)
            ref = LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 3, x)
            rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
            line = f"K7 {str(dt)[6:]} {dia.vshape} bs=3: rel L2 {rel:.3e} (tol {tol:g})"
            if dt == torch.float32:
                ms = cuda_ms(lambda: LK.dia_matvec_bs(data, dia.offsets, dia.vshape, 3, x), 200)
                plain_ms = cuda_ms(lambda: LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 3, x), 10)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                if m == n:
                    out["K7"] = dict(max_abs_err=float((got - ref).abs().max()), ms=ms, plain_ms=plain_ms)
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K7 disagrees with its plain version in {dt} at {dia.vshape}: {rel:.3e} > {tol:g}")
        del dia, data
    # K5's tables: raw (no masks) builds of the bs=3 form and of the P2
    # n_p2 form, beside unit-factor K1 / K4 tables of the same planes
    p2 = make_problem(n_p2, np.float32, dev, degree=2)[4]
    ones3 = np.ones((3,) + clf.vshape)
    keep2 = p2._split_classes(np.ones(p2.vshape))
    tables = (
        ("bs=3 grid", LK.build_fold_table(clf), LK.assemble_fold_lean_factored,
         LK.build_fold_table(clf, LK._detect_factored_masks(ones3, 0 * ones3), ones3, 0 * ones3)),
        ("P2 blocked", LK.build_fold_table(p2), LK.assemble_fold_lean_blocked,
         LK.build_fold_table(p2, LK._detect_factored_masks(keep2, 0 * keep2, p2._blocked_pads()),
                             keep2, 0 * keep2)),
        ("P2 refined r=2", LK.build_fold_table(p2, _refined=True), None, None),
    )
    for name, raw, unit_kernel, unit in tables:
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
            tab = raw.on(dev, dt)
            got = LK.assemble_fold_lean_raw(tab, 0.013)
            ref = LK.assemble_fold_lean_raw_plain(tab, 0.013)
            err = float((got - ref).abs().max())
            rel = err / float(ref.abs().max())
            line = f"K5 {name} {str(dt)[6:]} {tuple(got.shape)}: max|d|/max|ref| {rel:.3e} (tol {tol:g})"
            same = True
            if unit_kernel is not None:
                same = torch.equal(got, unit_kernel(unit.on(dev, dt), 0.013, 1.0))
                line += f", equal to {unit_kernel.__name__} with unit factors: {same}"
            if dt == torch.float32:
                ms = cuda_ms(lambda: LK.assemble_fold_lean_raw(tab, 0.013), 20)
                plain_ms = cuda_ms(lambda: LK.assemble_fold_lean_raw_plain(tab, 0.013), 2, 1)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
                if name == "P2 blocked":
                    out["K5"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
            print(line, flush=True)
            if not rel <= tol or not same:
                fail(f"K5 on the {name} table in {dt}: {rel:.3e} > {tol:g} or not equal to the unit-factor "
                     f"assembler")
            del got, ref
        raw._on.clear()
    return out


def build_bs3(dev, n):
    """bench.py's BENCH_BS=3 problem at n through the port's entry points
    (float32): the fold operator (K1 at bs=3), the manufactured b
    (bench.py:504-515, as for every bs > 1 run), the 4-level hierarchy down
    to 9^3 and its Chebyshev 3+3 GMG (bench.py:576-581).  Returns (V, mpc,
    clf, A, b, ops, masks, M, host seconds of the problem set-up, of the
    rest)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt

    t0 = time.time()
    V, bc, mpc, a, clf = make_elasticity(n, np.float32, dev)
    t_setup = time.time() - t0
    t0 = time.time()
    A = clf.assemble()
    b = A.matvec(manufactured_u0(clf, dev))
    ops, masks = dmt.build_gmg_hierarchy(
        lambda m: clf if m == n else make_elasticity(m, np.float32, dev)[4], n, 4, min_n=8)
    ops[0] = A
    M = dmt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev", n_pre=3, n_post=3)
    torch.cuda.synchronize()
    return V, mpc, clf, A, b, ops, masks, M, t_setup, time.time() - t0


def elasticity_path(dev, n, measure=True):
    """Phase 4c: bench.py's BENCH_BS=3 problem through the port's entry
    points (float32).  Returns (counts, summary)."""
    import torch

    import dolfinx_mpc_tpu_torch as dmt

    reset_counts()
    V, mpc, clf, A, b, ops, masks, M, t_setup, t_build = build_bs3(dev, n)
    t0 = time.time()
    x, its, rnorm = dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg = time.time() - t0
    u = mpc.finalized.backsubstitution(x)
    torch.cuda.synchronize()
    counts = read_counts(("K1", "K2", "K7"))

    if not bool(torch.isfinite(u).all()):
        fail(f"bs=3 path n={n}: the solution is not finite")
    # float64 solve of the same system: CG on the plain float64 operator,
    # preconditioned by the hierarchy's operators cast to float64 (K7 f64)
    A64 = plain_operator(A, torch.float64)
    M64 = dmt.LatticeGMG([cast_operator(o, torch.float64) for o in ops], free_masks=[m.double() for m in masks],
                         smoother="chebyshev", n_pre=3, n_post=3)
    x_ref, its_ref, _ = dmt.cg(A64.matvec, b.double(), M=M64, rtol=1e-12, atol=0.0, max_it=500)
    eta, rel_res, fwd = error_gates(A, b, x, x_ref)
    summary = dict(n=n, dofs=V.num_dofs, setup_s=t_setup, build_s=t_build, its=its, rnorm=rnorm,
                   bnorm=float(torch.linalg.vector_norm(b)), cg_s=t_cg, rel_res=rel_res, eta=eta, fwd=fwd,
                   its_ref=its_ref, levels=[o.dia.vshape for o in ops], bounds=M._bounds)
    if measure:
        # phase breakdown on the built objects (launches here are not counted)
        xr = b / torch.linalg.vector_norm(b)
        summary["asm_ms"] = cuda_ms(lambda: clf.assemble(), 20)
        summary["spmv_ms"] = cuda_ms(lambda: A.matvec(xr), 100)
        summary["vcycle_ms"] = cuda_ms(lambda: M(xr), 10)
        reset_counts()
        t0 = time.time()  # a second, warm solve
        _, its_w, _ = dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
        torch.cuda.synchronize()
        summary["ms_per_it"] = 1e3 * (time.time() - t0) / max(its_w, 1)
        summary["k7_per_it"] = read_counts(("K7",))["K7"] / max(its_w, 1)
    return counts, summary


def p2_levels(n):
    """bench.py's p-coarsened level list for degree 2 (bench.py:545-550):
    P2 at n, P1 on the same refined grid, then P1 halved down to n=8."""
    levels, m = [(2, n), (1, 2 * n)], n
    while m >= 8 and m % 2 == 0:
        levels.append((1, m))
        m //= 2
    return levels


def build_p2(dev, n):
    """bench.py's degree-2 problem at n through the port's entry points
    (float32): the fold operator (K4), the manufactured b, the p-coarsened
    hierarchy and its blocked_io GMG.  Returns (V, mpc, clf, A, b, ops,
    masks, M, host seconds of the problem set-up, of the rest)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt

    t0 = time.time()
    V, bc, mpc, a, clf = make_problem(n, np.float32, dev, degree=2)
    t_setup = time.time() - t0
    t0 = time.time()
    A = clf.assemble()
    # manufactured right-hand side b = A u0 (bench.py:504-515: the dofs
    # exceed 2^21)
    b = A.matvec(manufactured_u0(clf, dev))
    ops, masks = dmt.build_gmg_hierarchy(
        lambda lv: clf if lv == (2, n) else make_problem(lv[1], np.float32, dev, degree=lv[0])[4],
        n, 0, levels=p2_levels(n))
    ops[0] = A
    M = dmt.LatticeGMG(ops, free_masks=masks, blocked_io=True, smoother="chebyshev", n_pre=2, n_post=2)
    torch.cuda.synchronize()
    return V, mpc, clf, A, b, ops, masks, M, t_setup, time.time() - t0


def p2_path(dev, n, measure=True):
    """Phase 4b: bench.py's degree-2 problem through the port's entry points
    (float32), CG on the padded class stack.  Returns (counts, summary)."""
    import torch

    import dolfinx_mpc_tpu_torch as dmt

    reset_counts()
    V, mpc, clf, A, b, ops, masks, M, t_setup, t_build = build_p2(dev, n)
    bb = A.dia._to_blocked(b)
    t0 = time.time()
    xb, its, rnorm = dmt.cg(A.matvec_blocked, bb, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg = time.time() - t0
    x = A.dia._from_blocked(xb)
    u = mpc.finalized.backsubstitution(x)
    torch.cuda.synchronize()
    counts = read_counts(("K1", "K2", "K4", "K6"))

    if not bool(torch.isfinite(u).all()):
        fail(f"P2 path n={n}: the solution is not finite")
    # float64 solve of the same system: CG on the plain float64 operator,
    # preconditioned by the hierarchy's operators cast to float64
    A64 = plain_operator(A, torch.float64)
    M64 = dmt.LatticeGMG([cast_operator(o, torch.float64) for o in ops],
                         free_masks=[m.double() for m in masks], blocked_io=True,
                         smoother="chebyshev", n_pre=2, n_post=2)
    xb_ref, its_ref, _ = dmt.cg(A64.matvec_blocked, bb.double(), M=M64, rtol=1e-12, atol=0.0, max_it=500)
    eta, rel_res, fwd = error_gates(A, b, x, A.dia._from_blocked(xb_ref))
    summary = dict(n=n, dofs=V.num_dofs, setup_s=t_setup, build_s=t_build, its=its, rnorm=rnorm,
                   bnorm=float(torch.linalg.vector_norm(b)), cg_s=t_cg, rel_res=rel_res, eta=eta,
                   fwd=fwd, its_ref=its_ref, levels=p2_levels(n), bounds=M._bounds)
    if measure:
        # phase breakdown on the built objects (launches here are not counted)
        xr = bb / torch.linalg.vector_norm(bb)
        summary["asm_ms"] = cuda_ms(lambda: clf.assemble(), 10)
        summary["spmv_ms"] = cuda_ms(lambda: A.matvec_blocked(xr), 50)
        summary["vcycle_ms"] = cuda_ms(lambda: M(xr), 5)
        t0 = time.time()  # a second, warm solve
        dmt.cg(A.matvec_blocked, bb, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
        torch.cuda.synchronize()
        summary["ms_per_it"] = 1e3 * (time.time() - t0) / max(its, 1)
    return counts, summary


def main_path(dev, n=N_MAIN):
    """Phase 4: the default bench problem through the port's entry points
    (float32).  Returns (counts, summary dict)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner

    reset_counts()
    t0 = time.time()
    V, bc, mpc, a, clf = make_problem(n, np.float32, dev)
    t_setup = time.time() - t0
    t0 = time.time()
    A = clf.assemble()
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    b = dmt.set_bc(dmt.assemble_vector(L, mpc), [bc])
    ops, masks = dmt.build_gmg_hierarchy(lambda m: make_problem(m, np.float32, dev)[4], n, 4, min_n=8)
    ops[0] = A
    M = dmt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev", n_pre=2, n_post=2)
    torch.cuda.synchronize()
    t_build = time.time() - t0
    t0 = time.time()
    x, its, rnorm = dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg = time.time() - t0
    u = mpc.finalized.backsubstitution(x)
    torch.cuda.synchronize()
    counts = read_counts(("K1", "K2"))

    # checks by the repo's own means, with the plain SpMV in float64
    if not bool(torch.isfinite(u).all()):
        fail("main path: the solution is not finite")
    A64 = plain_operator(A, torch.float64)
    x_ref, its_ref, _ = dmt.cg(A64.matvec, b.double(), M=jacobi_preconditioner(A64.diagonal()),
                               rtol=1e-12, atol=0.0, max_it=5000)
    eta, rel_res, fwd = error_gates(A, b, x, x_ref)
    # phase breakdown on the built objects (launches here are not counted)
    xr = b / torch.linalg.vector_norm(b)
    ms_asm = cuda_ms(lambda: clf.assemble(), 20)
    ms_mv = cuda_ms(lambda: A.matvec(xr), 100)
    ms_vc = cuda_ms(lambda: M(xr), 10)
    t0 = time.time()  # a second, warm solve: the first pays one-time CUDA/cuBLAS set-up
    dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg_warm = time.time() - t0
    summary = dict(n=n, dofs=V.num_dofs, setup_s=t_setup, build_s=t_build, its=its, rnorm=rnorm,
                   bnorm=float(torch.linalg.vector_norm(b)), cg_s=t_cg, ms_per_it=1e3 * t_cg_warm / max(its, 1),
                   rel_res=rel_res, eta=eta, fwd=fwd, its_ref=its_ref, asm_ms=ms_asm, spmv_ms=ms_mv, vcycle_ms=ms_vc,
                   levels=[o.dia.vshape for o in ops], bounds=M._bounds)
    return counts, summary


def oracle_f64(dev, n=6, degree=1, marker=y_planes, kind="poisson"):
    """Phase 5: LinearProblem (Jacobi-CG) in float64 on the card vs scipy,
    for make_problem's Poisson form, make_elasticity's (with a vector
    source) or make_free's.  Returns (max error, CG iterations, kernel
    launches of the solve)."""
    import numpy as np
    import scipy.sparse.linalg as spla

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix

    if kind == "elasticity":
        V, bc, mpc, a, _ = make_elasticity(n, np.float64, dev)
        L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0]
                           + 0.5 * c.x[1] * v.value[..., 1] - v.value[..., 2])
    else:
        V, bc, mpc, a, _ = (make_free(n, np.float64, dev, degree) if kind == "free"
                            else make_problem(n, np.float64, dev, degree, marker))
        L = dmt.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0] * c.x[2]) * v.value)
    bcs = [] if bc is None else [bc]
    reset_counts()
    prob = dmt.LinearProblem(a, L, mpc, bcs=bcs,
                             petsc_options={"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12})
    u = prob.solve().x.array.cpu().numpy()
    counts = read_counts(KERNELS)
    A = assemble_matrix_scipy(a, bcs)
    b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, None, device="cpu"), [a], [bcs], None,
                                     device="cpu"), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)
    return float(np.abs(u - u_ref).max()), prob.its, counts


def main():
    if not (ROOT / "dolfinx_mpc_tpu_torch" / "__init__.py").is_file():
        fail(f"the dolfinx_mpc_tpu_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: the port's main path needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    t0 = time.time()
    from dolfinx_mpc_tpu_torch._build import load_kernels

    lib = load_kernels()
    print(f"build: {time.time() - t0:.2f} s ({Path(lib._name).name}); ptxas: "
          f"{ptxas_summary(Path(lib._name).with_suffix('.log'))}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cmp = compare_kernels(dev, gen)
    cmp.update(compare_blocked_kernels(dev, gen))
    cmp.update(compare_elasticity_kernels(dev, gen))

    counts, s = main_path(dev)
    print(f"main path n={s['n']} ({s['dofs']} dofs, f32, levels {s['levels']}): setup {s['setup_s']:.2f} s, "
          f"assembly+rhs+GMG build {s['build_s']:.2f} s, assembly {s['asm_ms']:.4f} ms, "
          f"fine SpMV {s['spmv_ms']:.4f} ms, V-cycle {s['vcycle_ms']:.4f} ms, "
          f"CG {s['its']} its in {s['cg_s']:.4f} s first solve, {s['ms_per_it']:.4f} ms/it warm, "
          f"rnorm {s['rnorm']:.3e} "
          f"(|b| {s['bnorm']:.3e}); recomputed in f64: |b-Ax|/|b| {s['rel_res']:.3e}, backward error "
          f"{s['eta']:.3e} (gate {BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s['fwd']:.3e} "
          f"(gate {FORWARD_ERROR_GATE:g}, f64 Jacobi-CG {s['its_ref']} its); launches {counts}",
          flush=True)
    if min(counts.values()) <= 0:
        fail(f"main path did not go through every kernel: {counts}")
    if not s["eta"] <= BACKWARD_ERROR_GATE:
        fail(f"main path backward error {s['eta']:.3e} > {BACKWARD_ERROR_GATE:g}")
    if not s["fwd"] <= FORWARD_ERROR_GATE:
        fail(f"main path solution differs from the f64 solve by {s['fwd']:.3e}")
    if abs(s["its"] - JAX_CPU_CG_ITS) > 2:
        fail(f"CG took {s['its']} its, JAX-CPU takes {JAX_CPU_CG_ITS} (+-2 allowed)")

    counts2 = None
    for n in (N_P2, N_P2_JAX):
        c2, s2 = p2_path(dev, n, measure=n == N_P2)
        line = (f"P2 path n={n} ({s2['dofs']} dofs, f32, levels {s2['levels']}): setup {s2['setup_s']:.2f} s, "
                f"assembly+rhs+GMG build {s2['build_s']:.2f} s, ")
        if n == N_P2:
            counts2 = c2
            line += (f"assembly {s2['asm_ms']:.4f} ms, fine SpMV (blocked) {s2['spmv_ms']:.4f} ms, "
                     f"V-cycle {s2['vcycle_ms']:.4f} ms, {s2['ms_per_it']:.4f} ms/it warm, ")
        print(line + f"CG {s2['its']} its in {s2['cg_s']:.4f} s first solve, rnorm {s2['rnorm']:.3e} "
              f"(|b| {s2['bnorm']:.3e}); recomputed in f64: |b-Ax|/|b| {s2['rel_res']:.3e}, backward "
              f"error {s2['eta']:.3e} (gate {BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s2['fwd']:.3e} "
              f"(gate {FORWARD_ERROR_GATE:g}, f64 GMG-CG {s2['its_ref']} its); launches {c2}", flush=True)
        if min(c2.values()) <= 0:
            fail(f"P2 path n={n} did not go through every kernel: {c2}")
        if not s2["eta"] <= BACKWARD_ERROR_GATE:
            fail(f"P2 path n={n} backward error {s2['eta']:.3e} > {BACKWARD_ERROR_GATE:g}")
        if not s2["fwd"] <= FORWARD_ERROR_GATE:
            fail(f"P2 path n={n} solution differs from the f64 solve by {s2['fwd']:.3e}")
        if abs(s2["its"] - JAX_CPU_P2_CG_ITS) > 2:
            fail(f"P2 CG took {s2['its']} its at n={n}, JAX-CPU takes {JAX_CPU_P2_CG_ITS} at n={N_P2_JAX} "
                 f"(+-2 allowed)")

    counts4 = None
    for n in (N_BS3, 32):
        c4, s4 = elasticity_path(dev, n, measure=n == N_BS3)
        line = (f"bs=3 path n={n} ({s4['dofs']} dofs, f32, levels {s4['levels']}): setup {s4['setup_s']:.2f} s, "
                f"assembly+rhs+GMG build {s4['build_s']:.2f} s, ")
        if n == N_BS3:
            counts4 = c4
            line += (f"assembly {s4['asm_ms']:.4f} ms, fine SpMV {s4['spmv_ms']:.4f} ms, "
                     f"V-cycle {s4['vcycle_ms']:.4f} ms, {s4['ms_per_it']:.4f} ms/it warm "
                     f"({s4['k7_per_it']:.1f} K7 launches/it), ")
        print(line + f"CG {s4['its']} its in {s4['cg_s']:.4f} s first solve, rnorm {s4['rnorm']:.3e} "
              f"(|b| {s4['bnorm']:.3e}); recomputed in f64: |b-Ax|/|b| {s4['rel_res']:.3e}, backward "
              f"error {s4['eta']:.3e} (gate {BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s4['fwd']:.3e} "
              f"(gate {FORWARD_ERROR_GATE:g}, f64 GMG-CG {s4['its_ref']} its); launches {c4}", flush=True)
        if c4["K1"] <= 0 or c4["K7"] <= 0 or c4["K2"] != 0:
            fail(f"bs=3 path n={n}: K1 and K7 must launch and K2 must not: {c4}")
        if not s4["eta"] <= BACKWARD_ERROR_GATE:
            fail(f"bs=3 path n={n} backward error {s4['eta']:.3e} > {BACKWARD_ERROR_GATE:g}")
        if not s4["fwd"] <= FORWARD_ERROR_GATE:
            fail(f"bs=3 path n={n} solution differs from the f64 solve by {s4['fwd']:.3e}")
        if abs(s4["its"] - JAX_CPU_BS3_CG_ITS[n]) > 2:
            fail(f"bs=3 CG took {s4['its']} its at n={n}, JAX-CPU takes {JAX_CPU_BS3_CG_ITS[n]} (+-2 allowed)")

    oracle_counts = {}
    for name, n, degree, marker, kind, need, forbid in (
            ("P1 n=6", 6, 1, y_planes, "poisson", ("K1", "K2"), ()),
            ("P2 n=3", 3, 2, y_planes, "poisson", ("K4", "K6"), ()),
            ("P1 n=6, blob set", 6, 1, blob, "poisson", ("K3", "K2"), ()),
            ("bs=3 P1 n=4", 4, 1, y_planes, "elasticity", ("K1", "K7"), ("K2",)),
            ("Dirichlet-free P1 n=6", 6, 1, None, "free", ("K5", "K2"), ("K1", "K4")),
            ("Dirichlet-free P2 n=3", 3, 2, None, "free", ("K5", "K6"), ("K1", "K4"))):
        err, its64, c = oracle_f64(dev, n, degree, marker, kind)
        print(f"f64 oracle {name} on the card: Jacobi-CG {its64} its, max|u - K(K^T A K)^-1 K^T b| "
              f"{err:.3e} (tol 1e-8); launches {c}", flush=True)
        if not err <= 1e-8:
            fail(f"f64 oracle {name}: error {err:.3e} > 1e-8")
        if min(c[k] for k in need) <= 0 or max((c[k] for k in forbid), default=0) != 0:
            fail(f"f64 oracle {name} did not go through {need} or went through {forbid}: {c}")
        oracle_counts[name] = c
    counts3 = oracle_counts["P1 n=6, blob set"]
    counts5 = oracle_counts["Dirichlet-free P2 n=3"]

    src = "dolfinx_mpc_tpu_torch/csrc/lattice_kernels.cu"
    pl = "dolfinx_mpc_tpu/ops/pallas_lattice.py"
    kernels = [
        dict(name="K1 assemble_fold_lean_factored (P1 main path; error and times at 15 x 65^3 f32)",
             route="cuda", source=src, replaces=f"{pl}:411", launches=counts["K1"], **cmp["K1"]),
        dict(name="K2 dia_matvec (P1 main path; error and times at 65^3 f32)", route="cuda", source=src,
             replaces=f"{pl}:766", launches=counts["K2"], **cmp["K2"]),
        dict(name="K3 assemble_fold_lean_masked (launches: f64 oracle P1 n=6 with the non-separable "
                  "set, 15 x 7^3; error and times: P2 n=64 with that set, 230 x 65^3 f32)", route="cuda",
             source=src, replaces=f"{pl}:526", launches=counts3["K3"], **cmp["K3"]),
        dict(name="K4 assemble_fold_lean_blocked (P2 main path; error and times at 230 x 65^3 f32)",
             route="cuda", source=src, replaces=f"{pl}:708", launches=counts2["K4"], **cmp["K4"]),
        dict(name="K5 assemble_fold_lean_raw (launches: f64 oracle, Dirichlet-free P2 n=3, 230 x 4^3; error "
                  "and times: the raw blocked P2 n=64 table, 230 x 65^3 f32)", route="cuda", source=src,
             replaces=f"{pl}:611", launches=counts5["K5"], **cmp["K5"]),
        dict(name="K6 blocked_matvec (P2 main path; error and times at 8 x 65^3 f32)", route="cuda", source=src,
             replaces=f"{pl}:916", launches=counts2["K6"], **cmp["K6"]),
        dict(name="K7 dia_matvec_bs (bs=3 path n=64; error and times at 65^3 x 3 f32)", route="cuda",
             source=src, replaces=f"{pl}:835", launches=counts4["K7"], **cmp["K7"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
