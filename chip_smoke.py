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
   n=32; K2 through the launch its DIAMatrix prepares, with warm, cold-L2,
   profiler and wrapper-host times), K4 on the P2 n=64 blocked table, K6 on
   that operator and on P2 n=32 (8 x 65^3 and 8 x 33^3, through the launch
   its BlockDIAMatrix prepares, with the same four times and, at 8 x 65^3,
   a sweep of its launch shape), K3 on P1 65^3 and P2 n=64 with a
   non-separable Dirichlet set (the y-planes and a ball on the y=0 face);
   K1 at bs=3 (135 x 65^3), K7 on the bs=3 grids 65^3, 33^3 and 17^3
   (through DIAMatrix's prepared launch, the same four times, x planes per
   block swept at 65^3 and 33^3), and K5 on the raw bs=3 grid table
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
   read after (K1 and K7 launched, K2 not at all; K7's launches also by
   grid); then the same at n=32;
4d. the contact path: benchmarks/bench_contact_3D.py --format bell --pc amg
   at NB=24/NT=20 (two stacked P1 vector tet boxes tied by the inelastic
   contact MPC, 74,658 dofs), through the port's entry points:
   MultiPointConstraint + create_contact_inelastic_condition (float64) ->
   assemble_matrix (float64 on the card) -> assemble_vector + apply_lifting
   + set_bc -> to_scipy -> bell_from_scipy (float32; on the card it packs
   the nonzeros for K8) -> smoothed_aggregation_amg (float32, rigid-body
   near-nullspace) -> cg in float32 (every fine matvec one K8 launch) ->
   backsubstitution, counters reset before and read after (K8 launched its
   + 1 times, no lattice kernel), with the peak device memory and the
   packing time; then K8 against its plain version on that operator in f32
   and f64, with the cuSPARSE CSR product A @ x on the whole operator timed
   beside it;
5. the float64 oracles on the card: LinearProblem (Jacobi-CG) against
   u = K (K^T A K)^-1 K^T b from scipy at P1 n=6, at P2 n=3, at P1 n=6
   with the non-separable set (the path of K3), at bs=3 P1 n=4 with a vector
   source (K1, K7), and for the reaction-diffusion form without Dirichlet
   dofs at P1 n=6 (K5, K2) and P2 n=3 (K5, K6), counters reset before each;
   the contact problem at NB=4/NT=3 through BELL + AMG + CG (K8) and through
   LinearProblem with pc gamg (CSR, no K8).

The last two lines are the card's nvidia-smi line and
{"ok": true, "device": {...}}; the line before them lists every kernel
(K1-K8) with its launches on its path, its error against the plain version,
its time, the plain version's, the cuSPARSE product's for the SpMVs (K2,
K6, K7, K8; null for the assemblers) and the bound: the larger of the bytes
it must move over 3.35 TB/s and its operations over 67 TFLOP/s (f32), from
this run's shapes (K8's on the nonzeros of its operator).  Cold-L2 times
write a 256 MB buffer before each timed launch; wrapper host times are the
host clock over 1,000 calls with no synchronize.  Nothing here imports
JAX.
"""

from __future__ import annotations

import ctypes
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
# CG iterations of the JAX package on the contact problem of
# benchmarks/bench_contact_3D.py at NB=24/NT=20 on the CPU, the benchmark's
# all-f32 solve recipe (constraint and assembly in float64; BELL, AMG, b and
# CG in float32): 9, rnorm 7.68e-07 at |b| 1.062, measured with
#   V, mpc, bcs, a, L = bench_contact_3D.py:31-64 at nb=24, nt=20
#   A = dmt.assemble_matrix(a, mpc, bcs=bcs)
#   b = jnp.asarray(np.asarray(dmt.set_bc(dmt.apply_lifting(
#       dmt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)), jnp.float32)
#   As = A.to_scipy(); B = bell_from_scipy(As, dtype=np.float32)
#   M = smoothed_aggregation_amg(As, bs=3, dtype=np.float32,
#                                nullspace=rigid_motions_nullspace(V))
#   jax.jit(lambda B_, M_, b_: cg(B_.matvec, b_, M=M_, rtol=1e-6, atol=1e-12,
#                                 max_it=3000))(B, M, b)
# (cg in place of the benchmark's cg_segmented, which continues the same
# Krylov iteration across dispatches).  AMG levels 74,658 -> 20,892 -> 9,246
# -> 9,054 (dense coarse inverse), BELL tiles (9344, 18, 8, 128), 651
# remainder entries.
JAX_CPU_CONTACT_CG_ITS = 9
NB_CONTACT, NT_CONTACT = 24, 20
# forward error gate of the float32 contact solve against a float64 solve of
# the same system: eps32 times a condition estimate of ~1e4 for P1
# elasticity at h = 1/24
CONTACT_FORWARD_ERROR_GATE = 1e-3
# H100 SXM published peaks: HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


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
        m = re.search(r"(fold_assemble_masked|fold_assemble_raw|fold_assemble|dia_matvec|"
                      r"blocked_matvec|bell_csr_matvec)_kernelI([fd])((?:L[ib]\d+E)*)E", ln)
        if m and "Compiling entry function" in ln:
            ints = "".join(f", {v}" for v in re.findall(r"L[ib](\d+)E", m.group(3)))
            name = f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}{ints}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"{m.group(1)}/{m.group(2)}"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name} {m.group(1)} regs, spill st/ld {spill} B")
            name, spill = None, "?"
    return "; ".join(out) or "no ptxas report"


def _rel_l2(a, b):
    import torch

    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


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


_FLUSH = []


def cold_ms(fn, reps, warmup=2):
    """Mean device time of one fn() in ms with a cold L2: before each call a
    256 MB buffer (five times the 50 MB L2) is written, then the call is
    timed alone by a pair of CUDA events."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda"))
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        _FLUSH[0].fill_(1.0)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def profiler_ms(fn, reps, kernel):
    """Device time per launch in ms of the kernels whose name holds
    `kernel`, from torch.profiler's key_averages over `reps` warm calls;
    None where the profiler records no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if kernel in e.key and e.device_type.name == "CUDA"]
    n = sum(e.count for e in ev)
    return sum(e.self_device_time_total for e in ev) / n / 1e3 if n else None


def host_ms(fn, calls=1000):
    """Host-clock time in ms per call of `calls` back-to-back fn() with no
    synchronize inside: the wrapper's own cost while the card keeps up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / calls


def spmv_times(fn, kernel, reps):
    """The SpMV table of one kernel: warm event time, cold-L2 event time,
    profiler device time per launch and the wrapper's host time."""
    return dict(warm_ms=cuda_ms(fn, reps), cold_ms=cold_ms(fn, max(reps // 4, 10)),
                prof_ms=profiler_ms(fn, 50, kernel), host_ms=host_ms(fn))


def fmt_times(t):
    prof = "not measured" if t["prof_ms"] is None else f"{t['prof_ms']:.4f} ms"
    return (f"warm {t['warm_ms']:.4f} ms, cold L2 {t['cold_ms']:.4f} ms, profiler device {prof}, "
            f"wrapper host {t['host_ms']:.4f} ms/call")


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


def wrapper(kid):
    """The wrapper function of kernel `kid`, whose .launches counts its
    launches."""
    import importlib

    module, name = KERNELS[kid]
    return getattr(importlib.import_module(module), name)


def reset_counts():
    for k in KERNELS:
        wrapper(k).launches = 0
    wrapper("K7").launches_by_grid.clear()


def read_counts(names):
    return {n: wrapper(n).launches for n in names}


# kernel id -> (module, wrapper)
_LK = "dolfinx_mpc_tpu_torch.ops.lattice_kernels"
KERNELS = {"K1": (_LK, "assemble_fold_lean_factored"), "K2": (_LK, "dia_matvec"),
           "K3": (_LK, "assemble_fold_lean_masked"), "K4": (_LK, "assemble_fold_lean_blocked"),
           "K5": (_LK, "assemble_fold_lean_raw"), "K6": (_LK, "blocked_matvec"), "K7": (_LK, "dia_matvec_bs"),
           "K8": ("dolfinx_mpc_tpu_torch.la.bell", "bell_matvec")}


def bound(nbytes, ops):
    """(bound_ms, bound_by): the least time of the card for work that must
    move `nbytes` through HBM and do `ops` f32 operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def fold_bound(tab, out):
    """Bound of an assembler launch on table `tab` with output `out`: the
    output written once plus the table and masks read once; operations are
    one addition per (table entry, window point) and the mask products
    (three per output value)."""
    nx, ny, nz = tab.dims
    inputs = [tab.planes, tab.ent, tab.coef] + [t for t in (tab.fac, tab.keep, tab.bc_ind) if t is not None]
    nbytes = sum(t.numel() * t.element_size() for t in [out] + inputs)
    ops = tab.ent.shape[0] * nx * ny * nz + 3 * out.numel()
    return bound(nbytes, ops)


def spmv_bound(stored, x, y, index_bytes=0):
    """Bound of an SpMV: its stored values, x and y moved once (plus index
    bytes), two operations per stored value."""
    nbytes = (stored + x.numel() + y.numel()) * x.element_size() + index_bytes
    return bound(nbytes, 2 * stored)


def csr_library_ms(S, x, reps):
    """(ms, y) of the PyTorch sparse CSR product A @ x (cuSPARSE) on the card,
    A built from the scipy matrix S in x's dtype: the yardstick beside an
    SpMV kernel, used nowhere in the port."""
    import numpy as np
    import torch

    S = S.tocsr()
    idx = np.int32 if S.nnz < 2 ** 31 else np.int64
    vals = S.data.astype(np.float32 if x.dtype == torch.float32 else np.float64)
    A = torch.sparse_csr_tensor(torch.as_tensor(S.indptr.astype(idx)), torch.as_tensor(S.indices.astype(idx)),
                                torch.as_tensor(vals), size=S.shape, device=x.device)
    return cuda_ms(lambda: A @ x, reps), A @ x


def compare_kernels(dev, gen):
    """Phase 3: K1 and K2 against their plain versions on the card, on the
    P1 main path's fine level (65^3; K2 also on its level 1, 33^3) and on
    the P2 path's level 1 (P1 at n = 2 N_P2, 129^3: their largest shapes).
    Returns the P1 main path's numbers for the kernels line."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
    from dolfinx_mpc_tpu_torch.ops.lattice import DIAMatrix

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
                bms, by = fold_bound(tab, got)
                if m == N_MAIN:
                    out["K1"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                     library_ms=None)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K1 disagrees with its plain version in {dt} at {tab.vshape}: {rel:.3e} > {tol:g}")
            del got, ref
        dia = clf.assemble().dia
        n = dia.shape[0]
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-13)):
            data = dia.data.to(dt).contiguous()
            op = DIAMatrix(data, dia.offsets, dia.vshape, 1)  # holds K2's prepared launch
            x = torch.randn(n, generator=gen, device=dev, dtype=torch.float64).to(dt)
            got = op.matvec(x)
            ref = LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 1, x)
            rel = float(torch.linalg.vector_norm(got - ref) / torch.linalg.vector_norm(ref))
            line = f"K2 {str(dt)[6:]} {dia.vshape}: rel L2 {rel:.3e} (tol {tol:g})"
            if dt == torch.float32:
                t = spmv_times(lambda: op.matvec(x), "dia_matvec_kernel", 200)
                plain_ms = cuda_ms(lambda: LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 1, x), 20)
                lib_ms, y_lib = csr_library_ms(dia.to_scipy(), x, 200)
                bms, by = spmv_bound(data.numel(), x, got)
                line += (f", kernel {fmt_times(t)}, plain {plain_ms:.4f} ms, cuSPARSE CSR {lib_ms:.4f} ms warm "
                         f"(rel L2 to the kernel {_rel_l2(y_lib, got):.1e}), bound {bms:.4f} ms ({by}); warm "
                         f"{lib_ms / t['warm_ms']:.2f}x cuSPARSE's speed, cold {bms / t['cold_ms']:.0%} of the bound")
                if m == N_MAIN:
                    out["K2"] = dict(max_abs_err=float((got - ref).abs().max()), ms=t["warm_ms"], plain_ms=plain_ms,
                                     bound_ms=bms, bound_by=by, library_ms=lib_ms)
                sweep = []
                for li in (1, 2, 4, 8, 16):
                    L = LK.DiaMatvecLaunch(data, dia.offsets, dia.vshape)
                    L.params.li = li
                    prof = profiler_ms(lambda: L(x), 50, "dia_matvec_kernel")
                    sweep.append(f"{li}: cold {cold_ms(lambda: L(x), 50):.4f} / device "
                                 f"{'not measured' if prof is None else f'{prof:.4f}'} ms")
                line += (f"\nK2 f32 {dia.vshape} by x planes per block (the launch takes "
                         f"{op._launch.params.li}): {'; '.join(sweep)}")
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K2 disagrees with its plain version in {dt} at {dia.vshape}: {rel:.3e} > {tol:g}")
            del op
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
            bms, by = fold_bound(tab, got)
            out["K4"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
        print(line, flush=True)
        if not rel <= tol or pad_nz:
            fail(f"K4 disagrees with its plain version in {dt}: {rel:.3e} > {tol:g} or {pad_nz} padded values")
        del got, ref
    del clf
    for m in (N_P2, N_P2 // 2):
        out.update(compare_k6(dev, gen, make_problem(m, np.float32, dev, degree=2)[4].assemble().dia, m == N_P2))
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
                bms, by = fold_bound(tab, got)
                if degree == 2:
                    out["K3"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                     library_ms=None)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K3 disagrees with its plain version in {dt} at degree {degree}: {rel:.3e} > {tol:g}")
            del got, ref
    return out


def compare_k6(dev, gen, dia, main):
    """K6 on the blocked P2 operator `dia` against its plain version on the
    card, f32 and f64, through the launch a BlockDIAMatrix prepares, with
    warm, cold-L2, profiler and wrapper-host times and the bound; on the
    main path's operator (`main`) also cuSPARSE on the flat dof vector and
    the sweep of threads x points per thread x x planes per block.  Returns
    the kernels line's numbers when `main`."""
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix

    out = {}
    for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-13)):
        data = dia.data.to(dt).contiguous()
        op = BlockDIAMatrix(data, dia.trips, dia.vshape, dia.r3)  # holds K6's prepared launch
        x = torch.randn(dia.shape[0], generator=gen, device=dev, dtype=torch.float64).to(dt)
        xb = dia._to_blocked(x).contiguous()
        got = op.matvec_blocked(xb)
        ref = LK.blocked_matvec_plain(data, dia.trips, dia.classes, xb)
        rel = _rel_l2(got, ref)
        line = f"K6 {str(dt)[6:]} {tuple(xb.shape)}: rel L2 {rel:.3e} (tol {tol:g})"
        if dt == torch.float32:
            p = op._launch.params
            t = spmv_times(lambda: op.matvec_blocked(xb), "blocked_matvec_kernel", 100)
            plain_ms = cuda_ms(lambda: LK.blocked_matvec_plain(data, dia.trips, dia.classes, xb), 10)
            bms, by = spmv_bound(data.numel(), xb, got, 8 * len(dia.trips))
            line += (f", kernel ({p.pts} points, {p.li} x planes per block, evict-first loads {p.stream}) "
                     f"{fmt_times(t)}, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); cold "
                     f"{bms / t['cold_ms']:.0%}, device {bms / (t['prof_ms'] or float('inf')):.0%} of the bound")
            if main:
                # the library call computes the same operator on the flat dof vector
                lib_ms, y_lib = csr_library_ms(dia.to_scipy(), dia._from_blocked(xb).contiguous(), 100)
                line += (f"; cuSPARSE CSR (flat) {lib_ms:.4f} ms warm (rel L2 to the kernel "
                         f"{_rel_l2(y_lib, dia._from_blocked(got)):.1e}), warm {lib_ms / t['warm_ms']:.2f}x its speed")
                out["K6"] = dict(max_abs_err=float((got - ref).abs().max()), ms=t["warm_ms"], plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by, library_ms=lib_ms)
                sweep = []
                for pts, li, stream in ((256, 1, 1), (512, 1, 1), (256, 3, 1), (512, 2, 1), (512, 3, 1), (512, 4, 1),
                                        (512, 3, 0)):
                    L = LK.BlockedMatvecLaunch(data, dia.trips, dia.classes)
                    L.params = LK.blocked_launch_params(dia.trips, dia.classes, dia.cdims, 4, pts=pts, li=li)
                    L.params.stream = stream
                    L.args = L.args[:2] + (ctypes.addressof(L.params),)
                    prof = profiler_ms(lambda: L(xb), 30, "blocked_matvec_kernel")
                    sweep.append(f"{pts}/{li}/{stream}: cold {cold_ms(lambda: L(xb), 30):.4f} / device "
                                 f"{'not measured' if prof is None else f'{prof:.4f}'} ms")
                line += (f"\nK6 f32 {tuple(xb.shape)} by points / x planes per block / evict-first loads (the launch "
                         f"takes {p.pts}/{p.li}/{p.stream}): {'; '.join(sweep)}")
        print(line, flush=True)
        if not rel <= tol:
            fail(f"K6 disagrees with its plain version in {dt} at {tuple(xb.shape)}: {rel:.3e} > {tol:g}")
        del op
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
    from dolfinx_mpc_tpu_torch.ops.lattice import DIAMatrix

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
            bms, by = fold_bound(tab, got)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
        print(line, flush=True)
        if not rel <= tol:
            fail(f"K1 at bs=3 disagrees with its plain version in {dt}: {rel:.3e} > {tol:g}")
        del got, ref
    for m in (n, n // 2, n // 4):
        dia = (clf if m == n else make_elasticity(m, np.float32, dev)[4]).assemble().dia
        for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-13)):
            data = dia.data.to(dt).contiguous()
            op = DIAMatrix(data, dia.offsets, dia.vshape, 3)  # holds K7's prepared launch
            x = torch.randn(dia.shape[0], generator=gen, device=dev, dtype=torch.float64).to(dt)
            got = op.matvec(x)
            ref = LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 3, x)
            rel = _rel_l2(got, ref)
            line = f"K7 {str(dt)[6:]} {dia.vshape} bs=3: rel L2 {rel:.3e} (tol {tol:g})"
            if dt == torch.float32:
                t = spmv_times(lambda: op.matvec(x), "dia_matvec_kernel", 200)
                plain_ms = cuda_ms(lambda: LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 3, x), 10)
                bms, by = spmv_bound(data.numel(), x, got)
                line += (f", kernel {fmt_times(t)}, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); cold "
                         f"{bms / t['cold_ms']:.0%}, device {bms / (t['prof_ms'] or float('inf')):.0%} of the bound")
                if m == n:
                    lib_ms, y_lib = csr_library_ms(dia.to_scipy(), x, 100)
                    line += (f"; cuSPARSE CSR {lib_ms:.4f} ms warm (rel L2 to the kernel {_rel_l2(y_lib, got):.1e}), "
                             f"warm {lib_ms / t['warm_ms']:.2f}x its speed")
                    out["K7"] = dict(max_abs_err=float((got - ref).abs().max()), ms=t["warm_ms"], plain_ms=plain_ms,
                                     bound_ms=bms, bound_by=by, library_ms=lib_ms)
                if m in (n, n // 2):
                    sweep = []
                    stream = op._launch.params.stream
                    for li, st in ((1, stream), (2, stream), (4, stream), (8, stream), (1, 1 - stream)):
                        L = LK.DiaBsMatvecLaunch(data, dia.offsets, dia.vshape, 3)
                        L.params.li, L.params.stream = li, st
                        prof = profiler_ms(lambda: L(x), 50, "dia_matvec_kernel")
                        sweep.append(f"{li}/{st}: warm {cuda_ms(lambda: L(x), 100):.4f} / cold "
                                     f"{cold_ms(lambda: L(x), 50):.4f} / device "
                                     f"{'not measured' if prof is None else f'{prof:.4f}'} ms")
                    line += (f"\nK7 f32 {dia.vshape} by x planes per block / evict-first loads (the launch takes "
                             f"{op._launch.params.li}/{stream}): {'; '.join(sweep)}")
            print(line, flush=True)
            if not rel <= tol:
                fail(f"K7 disagrees with its plain version in {dt} at {dia.vshape}: {rel:.3e} > {tol:g}")
            del op
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
                bms, by = fold_bound(tab, got)
                line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})"
                if name == "P2 blocked":
                    out["K5"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                     library_ms=None)
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
    k7_by_grid = {"x".join(map(str, g)): c for g, c in sorted(wrapper("K7").launches_by_grid.items(), reverse=True)}

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
                   its_ref=its_ref, levels=[o.dia.vshape for o in ops], bounds=M._bounds, k7_by_grid=k7_by_grid)
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


def make_contact(nb, nt, dtype, device, body_force=False):
    """benchmarks/bench_contact_3D.py:31-64 through the port: P1 vector tets
    of two stacked boxes, (0,0,0)-(1,1,1) with nb^3 and (0,0,1)-(1,1,2) with
    nt^3 cells, the interface facets tagged 1 (top side) and 2 (bottom
    side), create_contact_inelastic_condition(mt, 1, 2), Dirichlet 0 at z=0
    and (0, 0, -0.05) at z=2, 2 mu sym(grad u):sym(grad v) + lambda div u
    div v with mu=1, lambda=1.25 and the benchmark's zero source (or a body
    force, for the oracles).  Returns (V, bcs, mpc, a, L)."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import Mesh, create_box, meshtags

    bot = create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                bot.cell_type)
    V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)))
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts][:, :, 2], 1.0).all(axis=1)
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(on_iface & ext)
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    mt = meshtags(mesh, 2, iface, np.where(cz > 1.0, 1, 2))
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_contact_inelastic_condition(mt, 1, 2)
    mpc.finalize()
    bcs = [dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V),
           dmt.dirichletbc(np.array([0.0, 0.0, -0.05]),
                           dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 2.0)), V)]
    mu, lam = 1.0, 1.25
    a = dmt.BilinearForm(V, lambda u, v, c: 2 * mu * inner(sym(grad(u)), sym(grad(v)))
                         + lam * div(u) * conj(div(v)))
    if body_force:
        L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0]
                           + 0.5 * c.x[1] * v.value[..., 1] - v.value[..., 2])
    else:
        L = dmt.LinearForm(V, lambda v, c: 0.0 * v.value[..., 2])
    return V, bcs, mpc, a, L


def build_contact(dev, nb=NB_CONTACT, nt=NT_CONTACT):
    """bench_contact_3D.py --format bell --pc amg up to the solve, through
    the port's entry points: the constraint and the assembly in float64 on
    the card, b cast to float32, the BELL operator and the AMG hierarchy in
    float32.  Returns (V, mpc, a, bcs, b32, As, B, M, host seconds of the
    set-up, of assembly + rhs, of the BELL conversion, of the AMG set-up)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    t0 = time.time()
    V, bcs, mpc, a, L = make_contact(nb, nt, np.float64, dev)
    t_setup = time.time() - t0
    t0 = time.time()
    A = dmt.assemble_matrix(a, mpc, bcs)
    b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
    torch.cuda.synchronize()
    t_asm = time.time() - t0
    t0 = time.time()
    As = A.to_scipy()
    B = bell_from_scipy(As, dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    t_bell = time.time() - t0
    t0 = time.time()
    M = smoothed_aggregation_amg(As, bs=3, dtype=np.float32, nullspace=rigid_motions_nullspace(V), device=dev)
    torch.cuda.synchronize()
    t_amg = time.time() - t0
    return V, mpc, a, bcs, b.to(torch.float32), As, B, M, t_setup, t_asm, t_bell, t_amg


def contact_path(dev, nb=NB_CONTACT, nt=NT_CONTACT):
    """Phase 4d: bench_contact_3D.py --format bell --pc amg through the
    port's entry points, float32 solve.  Returns (counts, summary, the BELL
    operator, the scipy matrix)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.la.sparse import csr_from_scipy

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    V, mpc, a, bcs, b32, As, B, M, t_setup, t_asm, t_bell, t_amg = build_contact(dev, nb, nt)
    t0 = time.time()
    x, its, rnorm = dmt.cg(B.matvec, b32, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg = time.time() - t0
    u = mpc.finalized.backsubstitution(x)
    torch.cuda.synchronize()
    counts = read_counts(KERNELS)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    if not bool(torch.isfinite(u).all()):
        fail("contact path: the solution is not finite")
    # checks with the plain CSR SpMV in float64; the float64 reference is
    # Jacobi-CG on that operator
    A64 = csr_from_scipy(As, dtype=np.float64, device=dev)
    b64, x64 = b32.double(), x.double()
    r = b64 - A64.matvec(x64)
    a_inf = float(abs(As).sum(axis=1).max())
    eta = float(r.abs().max()) / (a_inf * float(x64.abs().max()) + float(b64.abs().max()))
    rel_res = float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))
    x_ref, its_ref, _ = dmt.cg(A64.matvec, b64, M=jacobi_preconditioner(A64.diagonal()), rtol=1e-12, atol=0.0,
                               max_it=50000)
    if its_ref >= 50000:
        fail("contact path: the float64 reference solve did not converge")
    fwd = float(torch.linalg.vector_norm(x64 - x_ref) / torch.linalg.vector_norm(x_ref))
    summary = dict(nb=nb, nt=nt, dofs=V.num_dofs, slaves=mpc.num_local_slaves, setup_s=t_setup, asm_s=t_asm,
                   bell_s=t_bell, amg_s=t_amg, its=its, rnorm=rnorm, bnorm=float(torch.linalg.vector_norm(b32)),
                   cg_s=t_cg, rel_res=rel_res, eta=eta, fwd=fwd, its_ref=its_ref, nnz=As.nnz,
                   tiles=tuple(B.data.shape), rem=int(B.rem_data.shape[0]), levels=[o.shape for o in M.ops],
                   level_formats=[type(o).__name__ for o in M.ops], peak_mb=peak_mb,
                   tiles_mb=B.data.numel() * B.data.element_size() / 1e6, packed_mb=B.packed.nbytes / 1e6,
                   packed_nnz=B.packed.nnz, threads_per_row=B.packed.threads_per_row)
    # phase breakdown on the built objects (launches here are not counted)
    from dolfinx_mpc_tpu_torch.la.bell import bell_matvec, bell_pack

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()  # the packing BellMatrix does at construction, again on its own
    P = bell_pack(B.data, B.cols, B.rem_data, B.rem_rows, B.rem_cols, B.shape)
    torch.cuda.synchronize()
    summary["pack_s"] = time.time() - t0
    summary["pack_transient_mb"] = (torch.cuda.max_memory_allocated() - mem0) / 1e6
    del P
    xr = b32 / torch.linalg.vector_norm(b32)
    summary["asm_ms"] = cuda_ms(lambda: dmt.assemble_matrix(a, mpc, bcs), 3, 1)
    summary["k8_ms"] = cuda_ms(lambda: bell_matvec(B, xr), 100)
    summary["spmv_ms"] = cuda_ms(lambda: B.matvec(xr), 100)
    summary["vcycle_ms"] = cuda_ms(lambda: M(xr), 10)
    reset_counts()
    t0 = time.time()  # a second, warm solve
    _, its_w, _ = dmt.cg(B.matvec, b32, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    summary["ms_per_it"] = 1e3 * (time.time() - t0) / max(its_w, 1)
    summary["k8_per_it"] = read_counts(("K8",))["K8"] / max(its_w, 1)
    return counts, summary, B, As


def compare_bell_kernel(dev, gen, B, As):
    """Phase 4d: K8 against its plain version (bell_packed_matvec_plain) and
    the tile product + remainder on the contact operator, in f32 (the path's
    B) and f64, with its warm, cold-L2, profiler and wrapper-host times, the
    cuSPARSE CSR product of the whole operator beside it, the bound on the
    nonzeros and, labelled, the bound of the padded tiles (what a tile stream
    must read); then K8's warm
    and cold times at other sub-warp widths, for the record."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.la import bell as BL

    n_rows, n_cols = B.shape
    S = As.copy()  # the whole operator, remainder included, on the same nonzeros as K8's
    S.eliminate_zeros()
    out = {}
    for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
        Bd = B if dt == torch.float32 else BL.bell_from_scipy(As, dtype=np.float64, device=dev)
        P = Bd.packed
        x = torch.randn(n_cols, generator=gen, device=dev, dtype=torch.float64).to(dt)
        got = BL.bell_matvec(Bd, x)
        ref = BL.bell_packed_matvec_plain(P, x)
        tiles = BL.bell_matvec_plain(Bd.data, Bd.cols, x, n_rows).index_add_(
            0, Bd.rem_rows, Bd.rem_data * x[Bd.rem_cols])
        rel, rel_tiles = _rel_l2(got, ref), _rel_l2(got, tiles)
        t = spmv_times(lambda: Bd.matvec(x), "bell_csr_matvec_kernel", 200)
        lib_ms, y_lib = csr_library_ms(S, x, 200)
        plain_ms = cuda_ms(lambda: BL.bell_packed_matvec_plain(P, x), 20, 2)
        bms, by = spmv_bound(P.nnz, x, got, P.nnz * 4 + P.row_ptr.numel() * 4)
        tile_bms, _ = spmv_bound(Bd.data.numel(), x, got, Bd.cols.numel() * Bd.cols.element_size())
        print(f"K8 {str(dt)[6:]} packed {P.nnz} nonzeros of {n_rows} rows ({P.nbytes / 1e6:.1f} MB; tiles "
              f"{tuple(Bd.data.shape)} {Bd.data.numel() * Bd.data.element_size() / 1e6:.1f} MB + "
              f"{int(Bd.rem_data.shape[0])} remainder entries), {P.threads_per_row} threads per row: rel L2 {rel:.3e} "
              f"to plain (tol {tol:g}), {rel_tiles:.3e} to the tile product + remainder; kernel {fmt_times(t)}; "
              f"plain {plain_ms:.4f} ms; cuSPARSE CSR (whole operator, {S.nnz} nonzeros) {lib_ms:.4f} ms warm (rel L2 "
              f"to the kernel {_rel_l2(y_lib, got):.1e}); bound on the nonzeros {bms:.4f} ms ({by}); bound of a stream of "
              f"the padded tiles {tile_bms:.4f} ms; warm {lib_ms / t['warm_ms']:.2f}x cuSPARSE's speed, cold "
              f"{bms / t['cold_ms']:.0%} of the bound", flush=True)
        if not (rel <= tol and rel_tiles <= tol):
            fail(f"K8 disagrees with its plain version in {dt}: {rel:.3e} / {rel_tiles:.3e} > {tol:g}")
        if dt == torch.float32:
            out["K8"] = dict(max_abs_err=float((got - ref).abs().max()), ms=t["warm_ms"], plain_ms=plain_ms,
                             bound_ms=bms, bound_by=by, library_ms=lib_ms)
            sweep = []
            for g in (4, 8, 16, 32):
                L = BL._K8Launch(P)
                L.g = g
                sweep.append(f"{g}: warm {cuda_ms(lambda: L(x), 200):.4f} / cold {cold_ms(lambda: L(x), 50):.4f} ms")
            print(f"K8 f32 by threads per row (the path takes {P.threads_per_row}): {'; '.join(sweep)}", flush=True)
        del Bd, P, got, ref, tiles
    return out


def oracle_contact_f64(dev, nb=4, nt=3, through="bell"):
    """Phase 5, contact: the contact problem with a body force in float64 on
    the card against K (K^T A K)^-1 K^T b, either through BELL + AMG (with
    smoothed levels: coarse_size 100) + CG, as the contact path solves, or
    through LinearProblem with pc gamg (the CSR operator).  Returns (max
    error, CG iterations, kernel launches of the solve)."""
    import numpy as np
    import scipy.sparse.linalg as spla

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy
    from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    V, bcs, mpc, a, L = make_contact(nb, nt, np.float64, dev, body_force=True)
    reset_counts()
    if through == "bell":
        A = dmt.assemble_matrix(a, mpc, bcs)
        b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
        As = A.to_scipy()
        B = bell_from_scipy(As, dtype=np.float64, device=dev)
        M = smoothed_aggregation_amg(As, bs=3, dtype=np.float64, nullspace=rigid_motions_nullspace(V),
                                     coarse_size=100, device=dev)
        x, its, _ = dmt.cg(B.matvec, b, M=M, rtol=1e-12, atol=0.0, max_it=500)
        u = mpc.finalized.backsubstitution(x).cpu().numpy()
    else:
        prob = dmt.LinearProblem(a, L, mpc, bcs=bcs,
                                 petsc_options={"ksp_type": "cg", "pc_type": "gamg", "ksp_rtol": 1e-12})
        u = prob.solve().x.array.cpu().numpy()
        its = prob.its
    counts = read_counts(KERNELS)
    A0 = dmt.assemble_matrix(a, None, bcs, device="cpu").to_scipy()
    b0 = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, None, device="cpu"), [a], [bcs]), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A0 @ K).tocsc(), K.T @ b0)
    return float(np.abs(u - u_ref).max()), its, counts


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

    counts4 = k7_by_grid = None
    for n in (N_BS3, 32):
        c4, s4 = elasticity_path(dev, n, measure=n == N_BS3)
        line = (f"bs=3 path n={n} ({s4['dofs']} dofs, f32, levels {s4['levels']}): setup {s4['setup_s']:.2f} s, "
                f"assembly+rhs+GMG build {s4['build_s']:.2f} s, ")
        if n == N_BS3:
            counts4, k7_by_grid = c4, s4["k7_by_grid"]
            line += (f"assembly {s4['asm_ms']:.4f} ms, fine SpMV {s4['spmv_ms']:.4f} ms, "
                     f"V-cycle {s4['vcycle_ms']:.4f} ms, {s4['ms_per_it']:.4f} ms/it warm "
                     f"({s4['k7_per_it']:.1f} K7 launches/it), ")
        print(line + f"CG {s4['its']} its in {s4['cg_s']:.4f} s first solve, rnorm {s4['rnorm']:.3e} "
              f"(|b| {s4['bnorm']:.3e}); recomputed in f64: |b-Ax|/|b| {s4['rel_res']:.3e}, backward "
              f"error {s4['eta']:.3e} (gate {BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s4['fwd']:.3e} "
              f"(gate {FORWARD_ERROR_GATE:g}, f64 GMG-CG {s4['its_ref']} its); launches {c4}, K7 by grid "
              f"{s4['k7_by_grid']}", flush=True)
        if c4["K1"] <= 0 or c4["K7"] <= 0 or c4["K2"] != 0:
            fail(f"bs=3 path n={n}: K1 and K7 must launch and K2 must not: {c4}")
        if not s4["eta"] <= BACKWARD_ERROR_GATE:
            fail(f"bs=3 path n={n} backward error {s4['eta']:.3e} > {BACKWARD_ERROR_GATE:g}")
        if not s4["fwd"] <= FORWARD_ERROR_GATE:
            fail(f"bs=3 path n={n} solution differs from the f64 solve by {s4['fwd']:.3e}")
        if abs(s4["its"] - JAX_CPU_BS3_CG_ITS[n]) > 2:
            fail(f"bs=3 CG took {s4['its']} its at n={n}, JAX-CPU takes {JAX_CPU_BS3_CG_ITS[n]} (+-2 allowed)")

    counts8, s8, B, As = contact_path(dev)
    lattice = {k: v for k, v in counts8.items() if k != "K8"}
    print(f"contact path NB={s8['nb']}/NT={s8['nt']} ({s8['dofs']} dofs, {s8['slaves']} slaves, {s8['nnz']} nonzeros; "
          f"BELL tiles {s8['tiles']} + {s8['rem']} remainder entries; AMG levels {s8['levels']} as "
          f"{s8['level_formats']}): host set-up {s8['setup_s']:.2f} s, assembly + rhs {s8['asm_s']:.2f} s first "
          f"(tables included), assembly {s8['asm_ms']:.4f} ms warm, BELL conversion {s8['bell_s']:.2f} s, "
          f"AMG set-up {s8['amg_s']:.2f} s, packing {s8['pack_s']:.3f} s ({s8['packed_nnz']} nonzeros, "
          f"{s8['packed_mb']:.1f} MB beside {s8['tiles_mb']:.1f} MB of tiles, {s8['pack_transient_mb']:.1f} MB peak "
          f"while packing, {s8['threads_per_row']} threads per row), peak device memory of build + solve "
          f"{s8['peak_mb']:.1f} MB, K8 alone {s8['k8_ms']:.4f} ms, BELL matvec (one K8 launch) "
          f"{s8['spmv_ms']:.4f} ms, V-cycle {s8['vcycle_ms']:.4f} ms, CG {s8['its']} its in {s8['cg_s']:.4f} s "
          f"first solve, {s8['ms_per_it']:.4f} ms/it warm ({s8['k8_per_it']:.1f} K8 launches/it), rnorm "
          f"{s8['rnorm']:.3e} (|b| {s8['bnorm']:.3e}); recomputed in f64: |b-Ax|/|b| {s8['rel_res']:.3e}, backward "
          f"error {s8['eta']:.3e} (gate {BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s8['fwd']:.3e} (gate "
          f"{CONTACT_FORWARD_ERROR_GATE:g}, f64 Jacobi-CG {s8['its_ref']} its); launches {counts8}", flush=True)
    if counts8["K8"] != s8["its"] + 1 or max(lattice.values()) != 0:
        fail(f"contact path: K8 must launch its + 1 = {s8['its'] + 1} times (one per matvec) and no lattice "
             f"kernel: {counts8}")
    if not s8["eta"] <= BACKWARD_ERROR_GATE:
        fail(f"contact path backward error {s8['eta']:.3e} > {BACKWARD_ERROR_GATE:g}")
    if not s8["fwd"] <= CONTACT_FORWARD_ERROR_GATE:
        fail(f"contact path solution differs from the f64 solve by {s8['fwd']:.3e}")
    if abs(s8["its"] - JAX_CPU_CONTACT_CG_ITS) > 2:
        fail(f"contact CG took {s8['its']} its, JAX-CPU takes {JAX_CPU_CONTACT_CG_ITS} (+-2 allowed)")
    cmp.update(compare_bell_kernel(dev, gen, B, As))
    del B, As

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
    for through, k8 in (("bell", True), ("gamg", False)):
        err, its64, c = oracle_contact_f64(dev, through=through)
        name = "BELL + AMG + CG" if k8 else "LinearProblem, pc gamg (CSR)"
        print(f"f64 oracle contact NB=4/NT=3, {name}, on the card: CG {its64} its, max|u - K(K^T A K)^-1 K^T b| "
              f"{err:.3e} (tol 1e-8); launches {c}", flush=True)
        if not err <= 1e-8:
            fail(f"f64 contact oracle through {through}: error {err:.3e} > 1e-8")
        if (c["K8"] > 0) != k8:
            fail(f"f64 contact oracle through {through}: K8 launches {c['K8']}")

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
        dict(name=f"K7 dia_matvec_bs (bs=3 path n=64, launches by grid {k7_by_grid}; error and times at 65^3 x 3 "
                  f"f32)", route="cuda", source=src, replaces=f"{pl}:835", launches=counts4["K7"],
             launches_by_grid=k7_by_grid, **cmp["K7"]),
        dict(name=f"K8 bell_matvec (contact path NB={NB_CONTACT}/NT={NT_CONTACT}; error and times on the packed "
                  f"layout of its operator, {s8['packed_nnz']} nonzeros, f32)", route="cuda",
             source="dolfinx_mpc_tpu_torch/csrc/bell_kernels.cu", replaces="dolfinx_mpc_tpu/la/bell.py:164",
             launches=counts8["K8"], **cmp["K8"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
