#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root (no arguments, one card).  Phases, one line
each (or a few), any failure exits non-zero:

1. the card: torch.cuda.is_available() must hold (there is no CPU path);
   name and power limit from nvidia-smi;
2. build the CUDA kernels (csrc/*.cu, one nvcc per source in parallel, -> ctypes);
3. each kernel against its plain PyTorch version on the card, at the paths'
   shapes, in float32 and float64, with CUDA-event times: K1 and K2 on the
   P1 n=64 operator and on P1 n=128 (the P2 path's level 1; K2 also at
   n=32; K2 through the launch its DIAMatrix prepares, with warm, cold-L2,
   profiler and wrapper-host times), K4 on the P2 n=64 blocked table, K6 on
   that operator and on P2 n=32 (8 x 65^3 and 8 x 33^3, through the launch
   its BlockDIAMatrix prepares, with the same four times and, at 8 x 65^3,
   a sweep of its launch shape), K3 on P1 65^3 and P2 n=64 with a
   non-separable Dirichlet set (the y-planes and a ball on the y=0 face);
   the assemblers K1, K3 and K4 through the launch their table prepares,
   with the same four times, the share of the bound, a 16-byte fill of the
   same output as the write yardstick and a sweep of the launch shape (row
   groups, evict-first stores);
   K1 at bs=3 (135 x 65^3), K7 on the bs=3 grids 65^3, 33^3 and 17^3
   (through DIAMatrix's prepared launch, the same four times, x planes per
   block swept at 65^3 and 33^3), and K5 on the raw bs=3 grid table
   (135 x 65^3), the raw blocked P2 n=64 table (230 x 65^3) and the refined
   r=2 P2 n=64 table (65 x 129^3), where K5 must also equal K1 / K4 with
   unit mask factors bit for bit, each through the launch its table
   prepares with the assemblers' four times, share of the bound, fill_
   yardstick and launch-shape sweep;
4. the P1 main path: the default problem of bench.py (P1 tets, n=64,
   274,625 dofs, periodic in x, Dirichlet at y=0/1), float32 on the card,
   through the port's entry points: assemble_matrix_lattice (fold) ->
   assemble_vector + set_bc -> 4-level GMG (Chebyshev smoother) -> cg ->
   backsubstitution, with the kernel launch counters reset just before and
   read just after; then bench.py's constrained-assembly metric on its
   operator (the whole lean fold assembly call, in MDoF/s and GB/s of
   operator data written), as for the P2 and bs=3 paths at n=64;
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
4e. the rotated slip-contact path at the contact path's size (74,658 dofs):
   the same boxes with the top box's x=0 side tagged 3, every point rotated
   by rotation_matrix([1, 1, 0], 0.3); the slave normal from
   facet_normal_approximation(method="project") in float64 on the card
   (exterior-facet assembly and Jacobi-CG), gated against
   create_normal_approximation on the slave blocks;
   create_contact_slip_condition; Dirichlet 0 at Z=0 and R (0, 0, -0.05)
   at Z=2; the traction R (0.1, 0, 0) on tag 3 as an exterior-facet linear
   form; then 4d's assembly, BELL + AMG + CG and gates (CG against the JAX
   package's CPU count, K8 its + 1 times, no lattice kernel), with the host
   time of each set-up phase, and K8 against its plain version on that
   operator;
5. the float64 oracles on the card: LinearProblem (Jacobi-CG) against
   u = K (K^T A K)^-1 K^T b from scipy at P1 n=6, at P2 n=3, at P1 n=6
   with the non-separable set (the path of K3), at bs=3 P1 n=4 with a vector
   source (K1, K7), and for the reaction-diffusion form without Dirichlet
   dofs at P1 n=6 (K5, K2) and P2 n=3 (K5, K6), counters reset before each;
   four problems of the general assembler (constrained_problem: slip
   elasticity, the rotated slip contact at NB=3/NT=2 with its traction, a
   2-D point-to-point tie, P2 stiffness plus a Robin facet term under a
   general constraint); the contact problem at NB=4/NT=3 through BELL + AMG
   + CG (K8) and through LinearProblem with pc gamg (CSR, no K8);
6. the port's demo_contact_2D and demo_elasticity at their CI sizes on the
   card, with their own checks;
7. the nest Stokes path: demo_stokes_nest's problem (Taylor-Hood P2-P1 on
   the channel rotated by pi/7, slip MPC on the walls) at 128 x 64, 74,691
   dofs, float64: nest assembly -> NestMatrix.to_bell (every block matvec
   and every matvec of the Chebyshev velocity preconditioner one K8
   launch) -> Chebyshev degree 5 | pressure-mass Jacobi -> bicgstab to
   rtol 1e-10 -> backsubstitution, counters reset before and read after
   (K8 3 + 21 + 16 per iteration, no lattice kernel); gates: the JAX
   package's CPU count +-5 %, max|u.n| on the slip wall <= 1e-8, the nest
   system's backward error <= 1e-8; host times of assembly, BELL
   conversion, preconditioner set-up and solve;
8. the Krylov paths: bench.py's P1 problem through LinearProblem with
   pc_type chebyshev (numpy-seeded probe): bcgs at n=64 in float64 and
   float32, and gmres (GMRES(30), max_it 1000) in float64 at n=120, the
   largest n at which the JAX package's GMRES(30) converges within max_it;
   K1 assembling and K2 in every matvec; gates: the JAX package's CPU
   counts (f64 +-2, f32 +-10 %; every GMRES solve converged within
   max_it), the main path's backward and forward error gates;
9. demo_periodic_gep at n=128, nev=4 (its own gate: the eigenvalues within
   1e-6 of scipy's eigsh on the reduced pencil), outer and inner counts
   printed beside the JAX package's CPU counts;
10. demo_stokes at 16 x 8 (GMRES(100) count within 2 % of the JAX
   package's 3,570), demo_stokes_nonlinear_nest at 12 x 6 and
   NonlinearProblem on tests/test_nonlinear.py's periodic problem (Newton
   counts equal to the JAX package's), each with its own checks;
11. the rest of the lattice path (slice11_phases), counters reset before
   each run and read after: 11a bench.py's P1 n=64 problem in float32 on
   the "csr" and "cells" side formats (matvec and diagonal against the fold
   operator's on three seeded vectors to 5e-6, the side products' time per
   matvec, then test_gmg's 4-level GMG over "cells" levels and cg, its count
   against the JAX package's CPU range, the error gates); 11b a coefficient
   form (kappa = 1 + x0 x1 in P1) on fold at n=64 through LinearProblem with
   cg + Chebyshev (matvec against the general assembler's MPCMatrix to
   5e-6, the count, the element kernel's time on 1,572,864 cells, the error
   gates); 11c demo_periodic_geometrical's problem at n=512 through
   LinearProblem (the 2-D element-kernel fold path, cg + Chebyshev, the
   count), 2-D P2 at n=256 and 2-D vector P1 at n=512 through LinearProblem,
   and K2 (n2 = 1), K6 (s2 = 1) and K7 (bs = 2, n2 = 1) on those operators
   against their plain versions; 11d vector P2 elasticity on fold in float64
   at n=32 (823,875 dofs, K7 at 65 offsets against its plain version, the
   error gates) and at n=16 (the count); 11e float64 oracles of csr, cells,
   the coefficient fold form, the 2-D square and vector P2;
12. complex scalars (slice12_phases), counters reset before each run and
   read after: 12a bench.py's P1 mesh at n=64 with a Bloch phase
   u(1, y, z) = e^{i pi/3} u(0, y, z), Dirichlet 0 at y=0/1 and a complex
   source on the "csr" format, in complex64 and complex128: cg + Chebyshev
   per probe seed against the JAX package's CPU range, cg + GMG over "csr"
   levels (Hermitian complex coarse inverse) against the port's own
   complex128 count, complex64's backward error in complex128 and its
   forward error against a complex128 solve, K2's launches by dtype; 12b
   K2 (65^3, 12a's operator), K7 (65^3 x 3), K6 (8 x 65^3) and K8 (the
   contact operator times e^{0.3 i}) in complex64 and complex128 against
   their plain versions (relative 5e-6 / 1e-12) with their times, bounds
   and the cuSPARSE complex CSR product's time (K7's device time also by
   CUDA events on its kernel alone, launched back to back, which stands
   where the profiler records no kernel); 12c six complex128 oracles
   (test_dtypes' lattice problem, the Bloch problem through LinearProblem
   and on "csr", bs=3 elasticity, P2, tied contact through BELL + AMG + CG),
   K2, K7, K6 and K8 each launched in complex128; 12d the list_timings()
   table of phase 12, every "~MPC:" span opened.

13. (run first, right after the build: its ranks share the card with
   this process) the distributed paths (slice13_phases), float64, every rank one
   spawned process (parallel.run_ranks), its launch counts read in the
   rank: 13a dryrun_multichip(8) on 8 gloo ranks sharing the card (the six
   scenarios of the JAX package's dry run, their counts against
   MULTICHIP_r05.json +-2, their own solution gates), then on 1 NCCL rank,
   and on NCCL over every card where there are two or more; 13b bench.py's
   P1 problem at n=64 through ShardedLatticeProblem with the two-level GMG
   (coarse LatticeGMG 32 -> 8 built on the card) on 4 gloo ranks sharing
   the card and on 1 NCCL rank (counts within 2 of each other), and bs=3
   elasticity at n=16 (K7); 13c the million-dof case of
   tests/test_lattice_spmd.py (n=102, 1,092,727 dofs, Chebyshev 4, rtol
   1e-11) on the 4 ranks; 13d the general path (ShardedLinearProblem, K8 on
   each rank's row block) at n=64 on the 4 ranks; each within 1e-7 of the
   port's single-device solve, with per-rank ms/it, the exchange's host
   ms/it, memory_report, peak device memory and launches; after the
   counts are read, each rank holds its case's SpMV kernel against the
   plain version on its own operator (K2 / K7 on the halo-extended slab
   box, K8 on the ghost-window row block; 1e-12 relative, f64); 13e the
   SoA element kernel against the cell-first kernel on the 1,572,864 cells
   of the coefficient form at n=64 (1e-12), with both times.
16. (after phase 12) the single-device forward step of entry.py, the JAX
   package's entry(): the periodic Poisson problem at n=8 (81 dofs),
   float64, K^H A K assembled from the compiled tables, 50 CG iterations
   with no early exit, backsubstitution, all plain torch; the step on the
   card against the same step on the CPU (rel L2 <= 1e-12) and against
   scipy's direct solve of the assembled system followed by
   backsubstitution (<= 1e-10), with its ms per step (CUDA events) and its
   launches per step (torch.profiler).

The last two lines are the card's nvidia-smi line and
{"ok": true, "device": {...}}; the line before them lists every kernel
(K1-K8, then K2, K7, K6 and K8 again for their complex instantiations,
with their phase-12 launches and complex64's numbers, complex128's under
"complex128") with its launches on its path (K8 also on the slip-contact path,
under "slip_contact", and on the nest Stokes path, under "stokes_nest"; K1,
K2, K7 and K8 on phase 13's runs, per rank, under "spmd"; K1
and K2 on the Krylov paths, under "krylov"; K2, K6 and K7 on phase 11's
paths and their checks on its new grids, under "lattice_formats"), its error against the plain version,
its time, the plain version's, the cuSPARSE product's for the SpMVs (K2,
K6, K7, K8; null for the assemblers) and the bound: the larger of the bytes
it must move over 3.35 TB/s and its operations over 67 TFLOP/s (f32), from
this run's shapes (K8's on the nonzeros of its operator).  Cold-L2 times
write a 256 MB buffer before each timed launch; wrapper host times are the
host clock over 1,000 calls with no synchronize.  Nothing here imports
JAX.
"""

from __future__ import annotations

import cmath
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
#   cg(A.matvec_blocked, A.to_blocked(b), M=M, rtol=1e-6, atol=1e-12,
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
# CG iterations of the JAX package on make_slip_contact's problem (the
# rotated slip contact with the traction) at NB=24/NT=20 on the CPU, the
# same all-f32 solve recipe: 34, rnorm 9.66e-07 at |b| 1.062 (441 slaves,
# 74,658 dofs; JAX 0.9.0 on the CPU of an H100 host), measured with
#   JAX_PLATFORMS=cpu python3 scripts/jax_slip_contact_cg.py --nb 24 --nt 20
# which builds the problem with the JAX package (the averaged normal, which
# the port's projected one equals to NORMAL_GATE here; constraint and
# assembly in float64; BELL, AMG, b and CG in float32, rtol 1e-6, CG jitted).
# At NB=8/NT=7 both packages take 19 on the CPU.
JAX_CPU_SLIP_CONTACT_CG_ITS = 34
# the projected and the averaged normal on a flat interface: equal up to the
# projection's CG tolerance
NORMAL_GATE = 1e-8
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


def kernel_times(fn, kernel, reps, calls=1000):
    """The four times of one kernel: warm event time, cold-L2 event time,
    profiler device time per launch and the wrapper's host time (over
    `calls` calls: fewer for the assemblers, whose launches outlast their
    host cost, so that the launch queue never fills)."""
    return dict(warm_ms=cuda_ms(fn, reps), cold_ms=cold_ms(fn, max(reps // 4, 10)),
                prof_ms=profiler_ms(fn, 50, kernel), host_ms=host_ms(fn, calls))


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


def make_problem(m, dtype, device, degree=1, marker=y_planes, side_format="fold"):
    """bench.py's make_problem for scalar Poisson, through the port (its
    lattice operator in `side_format`)."""
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
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format=side_format,
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
    """The lattice operator A with its data and side blocks cast to `dtype`
    (and made entrywise absolute, diagval too), over dia_types = (scalar DIA class, block-DIA
    class): the package's own by default, whose SpMV is K2 / K6 on the card."""
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, DIAMatrix, LatticeOperator

    dia_t, block_t = dia_types or (DIAMatrix, BlockDIAMatrix)

    def cast(v):
        return None if v is None else (v.to(dtype).abs() if absolute else v.to(dtype))

    data = cast(A.dia.data)
    dv = abs(A.diagval) if absolute else A.diagval
    if isinstance(A.dia, BlockDIAMatrix):
        dia = block_t(data, A.dia.trips, A.dia.vshape, A.dia.r3)
    else:
        dia = dia_t(data, A.dia.offsets, A.dia.vshape, A.dia.bs)
    return LatticeOperator(dia, dv, A.fold_axis, A.fold_mask, A.fold_pairs, fold_mask_b=A.fold_mask_b,
                           side_data=cast(A.side_data), side_cols=A.side_cols, side_rows=A.side_rows,
                           side_nrows=A.side_nrows, side_Aep=cast(A.side_Aep), side_er=A.side_er, slaves=A.slaves)


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


def error_gates(A, b, x, x_ref, wide=None):
    """(backward error, |b - A x| / |b|, forward error) of the float32
    (complex64) solution x (flat) of A x = b, recomputed in float64
    (complex128: `wide`) with the plain SpMV; x_ref is a solution of the
    same system in the wide dtype."""
    import torch

    wide = wide or torch.float64
    A64 = plain_operator(A, wide)
    b64, x64 = b.to(wide), x.to(wide)
    r = b64 - A64.matvec(x64)
    a_inf = float(plain_operator(A, wide, absolute=True).matvec(torch.ones_like(b64).real).max())
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
        w = wrapper(k)
        w.launches = 0
        if hasattr(w, "launches_by_dtype"):  # the SpMVs
            w.launches_by_dtype.clear()
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


def fold_bound(tab, out, masks):
    """Bound of an assembler launch on table `tab` with output `out`: the
    output written once plus the table and the masks the kernel reads
    (`masks`: "factored" the factor rows, "masked" the keep stack as bytes
    and the bc multiplicity stack, "raw" none) read once; operations are
    one addition per (table entry, window point) and, but for K5, the mask
    products (three per output value)."""
    nx, ny, nz = tab.dims
    inputs = [tab.planes, tab.ent, tab.coef] + {"factored": [tab.fac], "masked": [tab.bc_ind], "raw": []}[masks]
    nbytes = sum(t.numel() * t.element_size() for t in [out] + inputs)
    if masks == "masked":
        nbytes += tab.keep.numel()  # K3 reads the 0 / 1 keep stack as bytes
    ops = tab.ent.shape[0] * nx * ny * nz + (0 if masks == "raw" else 3 * out.numel())
    return bound(nbytes, ops)


FOLD_KERNEL = {"factored": "fold_assemble_kernel", "masked": "fold_assemble_masked_kernel",
               "raw": "fold_assemble_raw_kernel"}


def fold_timing(tab, masks, fn, plain_fn, got, err, reps, sweep=False):
    """The f32 numbers of an assembler call fn() on table `tab` (its
    launch's `masks`, "factored" for K1 / K4, "masked" for K3, "raw" for
    K5): warm, cold-L2, profiler device and wrapper host times, the plain
    version's time, the bound and the shares of it, the device time of
    torch's fill_ of an output of the same size (what a plain 16-byte
    write stream takes); with `sweep`, the device time of the table's
    prepared launch at other shapes (row groups, evict-first stores).
    Returns (text, the kernels line's numbers)."""
    import torch

    t = kernel_times(fn, FOLD_KERNEL[masks], reps, calls=200)
    plain_ms = cuda_ms(plain_fn, 2, 1)
    bms, by = fold_bound(tab, got, masks)
    buf = torch.empty_like(got)
    fill = profiler_ms(lambda: buf.fill_(1.0), 20, "")
    del buf
    launch = tab.launch(masks, tab.blocked if masks == "factored" else None)  # the wrapper's launch
    p = launch.params
    dev_share = bms / (t["prof_ms"] or float("inf"))
    text = (f", kernel ({p.g} x {p.kw} of {p.threads} threads, evict-first stores "
            f"{p.stream}, keep planes staged {p.stage}, window stride {tab.refine}) {fmt_times(t)}, plain {plain_ms:.4f} "
            f"ms, bound {bms:.4f} ms "
            f"({by}); device {dev_share:.0%}, warm {bms / t['warm_ms']:.0%}, cold {bms / t['cold_ms']:.0%} of the "
            f"bound; torch fill_ of the same output (a write yardstick) "
            f"{'not measured' if fill is None else f'{fill:.4f} ms device'}")
    if sweep:
        shape0 = (p.g, p.threads, p.stream)
        res = []
        for g in (g for g in (1, 2, 3, 4, 6) if g * p.kw <= 512):
            for stream in (shape0[2], 1 - shape0[2]):
                p.g, p.threads, p.stream = g, -(-g * p.kw // 32) * 32, stream
                prof = profiler_ms(lambda: launch(0.013, 1.0), 20, FOLD_KERNEL[masks])
                res.append(f"{g}/{stream}: {'not measured' if prof is None else f'{prof:.4f}'}")
        p.g, p.threads, p.stream = shape0
        text += f"\n  by row groups / evict-first stores (device ms): {'; '.join(res)}"
    return text, dict(max_abs_err=err, ms=t["warm_ms"], device_ms=t["prof_ms"], plain_ms=plain_ms, bound_ms=bms,
                      bound_by=by, library_ms=None)


def assembly_rate(clf, reps=20):
    """bench.py's constrained-assembly metric (bench.py:416-434, 486-495) on
    the port: the time per call of the whole lean fold assembly
    clf._assemble_fold_lean_kernel(jitter, 1.0), the jitter perturbed on
    every call, from the host clock of `reps` and of 1 back-to-back calls
    ending in synchronize, (T(reps) - T(1)) / (reps - 1).  Returns (ms per
    assembly, bytes of the operator's data it writes)."""
    import torch

    def run(k, seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(k):
            A = clf._assemble_fold_lean_kernel(seed * 1e-6 + 1e-7 * i, 1.0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, A

    run(2, 0.0)
    t1, _ = run(1, 1.0)
    tk, A = run(reps, 2.0)
    return 1e3 * (tk - t1) / (reps - 1), A.dia.data.numel() * A.dia.data.element_size()


def rate_text(label, dofs, ms, nbytes):
    """bench.py's line for the assembly metric: MDoF/s and the output's
    effective write rate."""
    return (f"{label} assembly (bench.py's metric): {ms:.4f} ms per call, {dofs / ms / 1e3:.1f} MDoF/s "
            f"({dofs} dofs), {nbytes / ms / 1e6:.1f} GB/s of operator data written ({nbytes / 1e6:.1f} MB)")


def spmv_bound(stored, x, y, index_bytes=0):
    """Bound of an SpMV: its stored values, x and y moved once (plus index
    bytes) at their element size (a complex value twice its real part's),
    two real operations per stored value, eight if complex."""
    nbytes = (stored + x.numel() + y.numel()) * x.element_size() + index_bytes
    return bound(nbytes, (8 if x.dtype.is_complex else 2) * stored)


def csr_library_ms(S, x, reps):
    """(ms, y) of the PyTorch sparse CSR product A @ x (cuSPARSE) on the card,
    A built from the scipy matrix S in x's dtype: the yardstick beside an
    SpMV kernel, used nowhere in the port."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch._dtypes import numpy_dtype

    S = S.tocsr()
    idx = np.int32 if S.nnz < 2 ** 31 else np.int64
    vals = S.data.astype(numpy_dtype(x.dtype))
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
                text, nums = fold_timing(tab, "factored", lambda: LK.assemble_fold_lean_factored(tab, 0.013, 1.0),
                                         lambda: LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0), got, err,
                                         50, sweep=True)
                if m == N_MAIN:
                    out["K1"] = nums
                line += text
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
                t = kernel_times(lambda: op.matvec(x), "dia_matvec_kernel", 200)
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
            text, out["K4"] = fold_timing(tab, "factored", lambda: LK.assemble_fold_lean_blocked(tab, 0.013, 1.0),
                                          lambda: LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0), got, err,
                                          20, sweep=True)
            line += text
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
                text, nums = fold_timing(tab, "masked", lambda: LK.assemble_fold_lean_masked(tab, 0.013, 1.0),
                                         lambda: LK.assemble_fold_lean_masked_plain(tab, 0.013, 1.0), got, err,
                                         20, sweep=True)
                if degree == 2:
                    out["K3"] = nums
                line += text
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
        xb = dia.to_blocked(x).contiguous()
        got = op.matvec_blocked(xb)
        ref = LK.blocked_matvec_plain(data, dia.trips, dia.classes, xb)
        rel = _rel_l2(got, ref)
        line = f"K6 {str(dt)[6:]} {tuple(xb.shape)}: rel L2 {rel:.3e} (tol {tol:g})"
        if dt == torch.float32:
            p = op._launch.params
            t = kernel_times(lambda: op.matvec_blocked(xb), "blocked_matvec_kernel", 100)
            plain_ms = cuda_ms(lambda: LK.blocked_matvec_plain(data, dia.trips, dia.classes, xb), 10)
            bms, by = spmv_bound(data.numel(), xb, got, 8 * len(dia.trips))
            line += (f", kernel ({p.pts} points, {p.li} x planes per block, evict-first loads {p.stream}) "
                     f"{fmt_times(t)}, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); cold "
                     f"{bms / t['cold_ms']:.0%}, device {bms / (t['prof_ms'] or float('inf')):.0%} of the bound")
            if main:
                # the library call computes the same operator on the flat dof vector
                lib_ms, y_lib = csr_library_ms(dia.to_scipy(), dia.from_blocked(xb).contiguous(), 100)
                line += (f"; cuSPARSE CSR (flat) {lib_ms:.4f} ms warm (rel L2 to the kernel "
                         f"{_rel_l2(y_lib, dia.from_blocked(got)):.1e}), warm {lib_ms / t['warm_ms']:.2f}x its speed")
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
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        line = f"K1 bs=3 {str(dt)[6:]} {tuple(got.shape)}: max|d|/max|ref| {rel:.3e} (tol {tol:g})"
        if dt == torch.float32:
            text, _ = fold_timing(tab, "factored", lambda: LK.assemble_fold_lean_factored(tab, 0.013, 1.0),
                                  lambda: LK.assemble_fold_lean_factored_plain(tab, 0.013, 1.0), got, err, 20,
                                  sweep=True)
            line += text
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
                t = kernel_times(lambda: op.matvec(x), "dia_matvec_kernel", 200)
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
    by_table = {}
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
                text, nums = fold_timing(tab, "raw", lambda: LK.assemble_fold_lean_raw(tab, 0.013),
                                         lambda: LK.assemble_fold_lean_raw_plain(tab, 0.013), got, err, 20,
                                         sweep=True)
                line += text
                by_table[f"{name} {tuple(got.shape)}"] = dict(device_ms=nums["device_ms"], bound_ms=nums["bound_ms"])
                if name == "P2 blocked":
                    out["K5"] = nums
            print(line, flush=True)
            if not rel <= tol or not same:
                fail(f"K5 on the {name} table in {dt}: {rel:.3e} > {tol:g} or not equal to the unit-factor "
                     f"assembler")
            del got, ref
        raw._on.clear()
    out["K5"]["tables"] = by_table
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
        summary["asm_rate"] = assembly_rate(clf)
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
    bb = A.to_blocked(b)
    t0 = time.time()
    xb, its, rnorm = dmt.cg(A.matvec_blocked, bb, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg = time.time() - t0
    x = A.from_blocked(xb)
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
    eta, rel_res, fwd = error_gates(A, b, x, A.from_blocked(xb_ref))
    summary = dict(n=n, dofs=V.num_dofs, setup_s=t_setup, build_s=t_build, its=its, rnorm=rnorm,
                   bnorm=float(torch.linalg.vector_norm(b)), cg_s=t_cg, rel_res=rel_res, eta=eta,
                   fwd=fwd, its_ref=its_ref, levels=p2_levels(n), bounds=M._bounds)
    if measure:
        # phase breakdown on the built objects (launches here are not counted)
        xr = bb / torch.linalg.vector_norm(bb)
        summary["asm_ms"] = cuda_ms(lambda: clf.assemble(), 10)
        summary["asm_rate"] = assembly_rate(clf)
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
    asm_rate = assembly_rate(clf)
    ms_mv = cuda_ms(lambda: A.matvec(xr), 100)
    ms_vc = cuda_ms(lambda: M(xr), 10)
    t0 = time.time()  # a second, warm solve: the first pays one-time CUDA/cuBLAS set-up
    dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg_warm = time.time() - t0
    summary = dict(n=n, dofs=V.num_dofs, setup_s=t_setup, build_s=t_build, its=its, rnorm=rnorm,
                   bnorm=float(torch.linalg.vector_norm(b)), cg_s=t_cg, ms_per_it=1e3 * t_cg_warm / max(its, 1),
                   rel_res=rel_res, eta=eta, fwd=fwd, its_ref=its_ref, asm_ms=ms_asm, asm_rate=asm_rate, spmv_ms=ms_mv,
                   vcycle_ms=ms_vc,
                   levels=[o.dia.vshape for o in ops], bounds=M._bounds)
    return counts, summary


def contact_mesh(nb, nt, side_tag=False, rotation=None):
    """The contact benchmark's mesh through the port: P1 tets of two stacked
    boxes, (0,0,0)-(1,1,1) with nb^3 and (0,0,1)-(1,1,2) with nt^3 cells,
    the interface facets tagged 1 (top side) and 2 (bottom side), with
    side_tag the top box's x=0 side facets tagged 3, and with a rotation R
    every point moved to R x after tagging.  Returns (mesh, meshtags)."""
    import numpy as np

    from dolfinx_mpc_tpu_torch.fem.mesh import Mesh, create_box, meshtags

    bot = create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                bot.cell_type)
    fverts, _, f2c = mesh.facets()
    fpts = mesh.points[fverts]
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(np.isclose(fpts[:, :, 2], 1.0).all(axis=1) & ext)
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    idx, vals = [iface], [np.where(cz > 1.0, 1, 2)]
    if side_tag:
        side = np.flatnonzero(np.isclose(fpts[:, :, 0], 0.0).all(axis=1) & ext & (fpts[:, :, 2] >= 1.0).all(axis=1))
        idx.append(side)
        vals.append(np.full(len(side), 3))
    mt = meshtags(mesh, 2, np.concatenate(idx), np.concatenate(vals))
    if rotation is not None:
        mesh.points[:] = mesh.points @ rotation.T
    return mesh, mt


def elasticity_form(V):
    """2 mu sym(grad u):sym(grad v) + lambda div u div v, mu=1, lambda=1.25."""
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym

    mu, lam = 1.0, 1.25
    return dmt.BilinearForm(V, lambda u, v, c: 2 * mu * inner(sym(grad(u)), sym(grad(v)))
                            + lam * div(u) * conj(div(v)))


def make_contact(nb, nt, dtype, device, body_force=False):
    """benchmarks/bench_contact_3D.py:31-64 through the port: contact_mesh,
    create_contact_inelastic_condition(mt, 1, 2), Dirichlet 0 at z=0 and
    (0, 0, -0.05) at z=2, elasticity_form and the benchmark's zero source
    (or a body force, for the oracles).  Returns (V, bcs, mpc, a, L)."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt

    mesh, mt = contact_mesh(nb, nt)
    V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)))
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_contact_inelastic_condition(mt, 1, 2)
    mpc.finalize()
    bcs = [dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V),
           dmt.dirichletbc(np.array([0.0, 0.0, -0.05]),
                           dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 2.0)), V)]
    if body_force:
        L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0]
                           + 0.5 * c.x[1] * v.value[..., 1] - v.value[..., 2])
    else:
        L = dmt.LinearForm(V, lambda v, c: 0.0 * v.value[..., 2])
    return V, bcs, mpc, elasticity_form(V), L


def make_slip_contact(nb, nt, dtype, device, times=None):
    """The rotated slip-contact problem through the port
    (scripts/jax_slip_contact_cg.py builds the same with the JAX package):
    contact_mesh with the side tag, rotated by R = rotation_matrix([1, 1, 0],
    0.3); the slave normal from facet_normal_approximation(V, mt, 1,
    method="project") in float64 on `device` (exterior-facet assembly and
    Jacobi-CG); create_contact_slip_condition(mt, 1, 2, n); Dirichlet 0 at
    Z=0 and R (0, 0, -0.05) at Z=2 (markers in the unrotated frame);
    elasticity_form; the traction R (0.1, 0, 0) on tag 3 as an exterior-facet
    linear form.  `times`, a dict, receives the host seconds of the normal
    projection and of the constraint and the largest difference between
    the projected normal and create_normal_approximation's on the slave
    blocks.  Returns (V, bcs, mpc, a, L)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import inner
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import (
        create_normal_approximation,
        facet_normal_approximation,
        rotation_matrix,
    )

    times = {} if times is None else times
    R = rotation_matrix([1.0, 1.0, 0.0], 0.3)
    mesh, mt = contact_mesh(nb, nt, side_tag=True, rotation=R)
    V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)))
    t0 = time.time()
    n = facet_normal_approximation(V, mt, 1, method="project", device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    times["normal_s"] = time.time() - t0
    n_avg = create_normal_approximation(V, mt, 1, device=device)
    slave_blocks = dmt.locate_dofs_topological(V, 2, mt.find(1))
    gap = (n.x.array - n_avg.x.array).reshape(-1, 3)[torch.as_tensor(slave_blocks, device=device)]
    times["normal_gap"] = float(gap.abs().max())
    t0 = time.time()
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_contact_slip_condition(mt, 1, 2, n)
    mpc.finalize()
    times["constraint_s"] = time.time() - t0

    def in_rot(marker):
        return lambda x: marker(R.T @ x[:3])

    bcs = [dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[2], 0.0))), V),
           dmt.dirichletbc(R @ np.array([0.0, 0.0, -0.05]),
                           dmt.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[2], 2.0))), V)]
    L = dmt.LinearForm(V, lambda v, c: inner(c["t"], v), integral="exterior_facet", entities=mt.find(3),
                       constants={"t": R @ np.array([0.1, 0.0, 0.0])})
    return V, bcs, mpc, elasticity_form(V), L


def build_contact(dev, nb=NB_CONTACT, nt=NT_CONTACT, slip=False, times=None):
    """bench_contact_3D.py --format bell --pc amg up to the solve, through
    the port's entry points, for tied contact (make_contact) or, with slip,
    the rotated slip contact (make_slip_contact, which fills `times`): the
    constraint and the assembly in float64 on the card, b cast to float32,
    the BELL operator and the AMG hierarchy in float32; with `times`, also
    the warm device times of assembly + rhs and of the rhs alone.  Returns (V, mpc,
    a, bcs, b32, As, B, M, host seconds of the set-up (for slip without the
    normal projection and the constraint), of assembly + rhs, of the BELL
    conversion, of the AMG set-up)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    record = times is not None
    times = {} if times is None else times
    t0 = time.time()
    if slip:
        V, bcs, mpc, a, L = make_slip_contact(nb, nt, np.float64, dev, times)
    else:
        V, bcs, mpc, a, L = make_contact(nb, nt, np.float64, dev)
    t_setup = time.time() - t0 - times.get("normal_s", 0.0) - times.get("constraint_s", 0.0)

    def assemble():
        A = dmt.assemble_matrix(a, mpc, bcs)
        return A, dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)

    t0 = time.time()
    A, b = assemble()
    torch.cuda.synchronize()
    t_asm = time.time() - t0
    if record:  # warm: the matrix, and the right-hand side alone
        times["asm_rhs_ms"] = cuda_ms(assemble, 3, 1)
        times["rhs_ms"] = cuda_ms(lambda: dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [bcs],
                                                                        mpc), bcs), 5, 1)
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


def contact_path(dev, nb=NB_CONTACT, nt=NT_CONTACT, slip=False):
    """Phase 4d (tied) or 4e (slip): bench_contact_3D.py --format bell --pc
    amg through the port's entry points, float32 solve.  Returns (counts,
    summary, the BELL operator, the scipy matrix)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.la.sparse import csr_from_scipy

    times = {}
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    V, mpc, a, bcs, b32, As, B, M, t_setup, t_asm, t_bell, t_amg = build_contact(dev, nb, nt, slip, times)
    t0 = time.time()
    x, its, rnorm = dmt.cg(B.matvec, b32, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    t_cg = time.time() - t0
    u = mpc.finalized.backsubstitution(x)
    torch.cuda.synchronize()
    counts = read_counts(KERNELS)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    if not bool(torch.isfinite(u).all()):
        fail(f"{'slip ' if slip else ''}contact path: the solution is not finite")
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
        fail(f"{'slip ' if slip else ''}contact path: the float64 reference solve did not converge")
    fwd = float(torch.linalg.vector_norm(x64 - x_ref) / torch.linalg.vector_norm(x_ref))
    summary = dict(nb=nb, nt=nt, dofs=V.num_dofs, slaves=mpc.num_local_slaves, setup_s=t_setup, asm_s=t_asm,
                   bell_s=t_bell, amg_s=t_amg, its=its, rnorm=rnorm, bnorm=float(torch.linalg.vector_norm(b32)),
                   cg_s=t_cg, rel_res=rel_res, eta=eta, fwd=fwd, its_ref=its_ref, nnz=As.nnz,
                   tiles=tuple(B.data.shape), rem=int(B.rem_data.shape[0]), levels=[o.shape for o in M.ops],
                   level_formats=[type(o).__name__ for o in M.ops], peak_mb=peak_mb,
                   tiles_mb=B.data.numel() * B.data.element_size() / 1e6, packed_mb=B.packed.nbytes / 1e6,
                   packed_nnz=B.packed.nnz, threads_per_row=B.packed.threads_per_row, **times)
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


def compare_bell_kernel(dev, gen, B, As, label="", sweep=True):
    """Phases 4d and 4e: K8 against its plain version
    (bell_packed_matvec_plain) and the tile product + remainder on a contact
    operator, in f32 (the path's B) and f64, with its warm, cold-L2,
    profiler and wrapper-host times, the cuSPARSE CSR product of the whole
    operator beside it, the bound on the nonzeros and, labelled, the bound
    of the padded tiles (what a tile stream must read); then, with sweep,
    K8's warm and cold times at other sub-warp widths, for the record."""
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
        t = kernel_times(lambda: Bd.matvec(x), "bell_csr_matvec_kernel", 200)
        lib_ms, y_lib = csr_library_ms(S, x, 200)
        plain_ms = cuda_ms(lambda: BL.bell_packed_matvec_plain(P, x), 20, 2)
        bms, by = spmv_bound(P.nnz, x, got, P.nnz * 4 + P.row_ptr.numel() * 4)
        tile_bms, _ = spmv_bound(Bd.data.numel(), x, got, Bd.cols.numel() * Bd.cols.element_size())
        print(f"K8{label} {str(dt)[6:]} packed {P.nnz} nonzeros of {n_rows} rows ({P.nbytes / 1e6:.1f} MB; tiles "
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
            by_width = []
            for g in (4, 8, 16, 32) if sweep else ():
                L = BL._K8Launch(P)
                L.g = g
                by_width.append(f"{g}: warm {cuda_ms(lambda: L(x), 200):.4f} / cold {cold_ms(lambda: L(x), 50):.4f} ms")
            if by_width:
                print(f"K8 f32 by threads per row (the path takes {P.threads_per_row}): {'; '.join(by_width)}",
                      flush=True)
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


def constrained_problem(kind, dev):
    """Phase 5's general-assembler problems in float64 on `dev`, each the
    input of a JAX-package test, solved: "slip" (tests/test_slip_and_periodic.py:89,
    slip on x=1 of a 6x6 P1 vector square, averaged normal, bc at x=0,
    source (1, -0.5)), "slip contact" (tests/test_contact.py:205 at NB=3 /
    NT=2 with make_slip_contact's traction), "p2p" (tests/test_contact.py:114,
    two 3x3 squares stacked at y=1, the block at (1, 2) tied to (0, 0),
    vector Laplacian, bc on the lower square's x=1 edge, source (1, -0.5))
    and "robin" (tests/test_surface_integral.py:35: P2 on a 4x4 square,
    stiffness plus 3 u v ds on y=1, the general constraint u(0.5, 1) =
    0.4 u(0.5, 0), source 1 + x y).  Returns (V, bcs, mpc, a, L)."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.constraints import create_point_to_point_constraint
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import (
        Mesh,
        create_rectangle,
        create_unit_square,
        locate_entities_boundary,
        meshtags,
    )
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import create_normal_approximation

    if kind == "slip contact":
        return make_slip_contact(3, 2, np.float64, dev)
    source = lambda v, c: v.value[..., 0] - 0.5 * v.value[..., 1]  # noqa: E731  inner((1, -0.5), v)
    mpc = None
    if kind == "slip":
        mesh = create_unit_square(6, 6)
        V = dmt.functionspace(mesh, ("Lagrange", 1, (2,)))
        mt = meshtags(mesh, 1, locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 1.0)), 1)
        bcs = [dmt.dirichletbc(np.zeros(2), dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 0.0)), V)]
        mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
        mpc.create_slip_constraint(V, (mt, 1), create_normal_approximation(V, mt, 1, device=dev), bcs)
        a, L = elasticity_form(V), dmt.LinearForm(V, source)
    elif kind == "p2p":
        bot = create_rectangle((0.0, 0.0), (1.0, 1.0), (3, 3))
        top = create_rectangle((0.0, 1.0), (1.0, 2.0), (3, 3))
        mesh = Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                    bot.cell_type)
        V = dmt.functionspace(mesh, ("Lagrange", 1, (2,)))
        bcs = [dmt.dirichletbc(np.zeros(2), dmt.locate_dofs_geometrical(
            V, lambda x: np.isclose(x[0], 1.0) & (x[1] <= 1.0)), V)]
        mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
        mpc.add_constraint_from_mpc_data(V, create_point_to_point_constraint(V, np.array([1.0, 2.0]),
                                                                             np.array([0.0, 0.0])))
        a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
        L = dmt.LinearForm(V, source)
    elif kind == "robin":
        mesh = create_unit_square(4, 4)
        V = dmt.functionspace(mesh, ("Lagrange", 2))
        facets = locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[1], 1.0))
        a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v))) + dmt.BilinearForm(
            V, lambda u, v, c: 3.0 * inner(u, v), integral="exterior_facet", entities=facets)
        mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
        mpc.create_general_constraint({np.array([0.5, 1.0]).tobytes(): {np.array([0.5, 0.0]).tobytes(): 0.4}})
        bcs = []
        L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[1]) * v.value)
    else:
        raise ValueError(kind)
    mpc.finalize()
    return V, bcs, mpc, a, L


def oracle_f64(dev, n=6, degree=1, marker=y_planes, kind="poisson"):
    """Phase 5: LinearProblem (Jacobi-CG) in float64 on the card vs scipy,
    for make_problem's Poisson form, make_elasticity's (with a vector
    source), make_free's or one of constrained_problem's.  Returns (max error, CG iterations, kernel
    launches of the solve)."""
    import numpy as np
    import scipy.sparse.linalg as spla

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix

    if kind in ("slip", "slip contact", "p2p", "robin"):
        V, bcs, mpc, a, L = constrained_problem(kind, dev)
    else:
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


# ---- slice 10: the other Krylov methods, the eigensolver, mixed spaces,
# ---- nest blocks and the Newton drivers (phases 7-10)

# A Krylov count moves under rounding-level changes of its input: on the P1
# problem below the card's b, assembled with atomics, differs from the CPU's
# by 5.6e-16 (relative) and that alone turns GMRES's 27 its into 29 and
# BiCGStab's 24 into 26 (swapping the two b's swaps the counts), and
# rebuilding the nest operator on the card moves its BiCGStab count between
# 1,789 and 2,008 at one probe (measured on an H100, PERF.md §6).  So a
# count is gated as a spread: the mean of the port's counts over the probe
# seeds *_SEEDS must lie in the range of the JAX package's counts over probe
# seeds and rounding-level changes, widened by the margin (5 %, 2 its, 10 %).
#
# BiCGStab iterations of the JAX package on demo_stokes_nest's problem at
# NX_NEST x NY_NEST (74,691 dofs) on the CPU of an H100 host, float64, the
# Chebyshev power iteration started from numpy's
# default_rng(seed).standard_normal(66,306), seeds 0-4, as assembled and
# with b changed by 2e-16 random relative noise:
#   python3 scripts/jax_stokes_nest_count.py --nx 128 --ny 64 --seeds 0 1 2 3 4 --perturb-b=0,2e-16
JAX_CPU_STOKES_NEST_ITS = (1918, 1932, 1982, 1958, 1716, 1884, 1715, 1868, 1744, 2123)
NX_NEST, NY_NEST = 128, 64
NEST_SEEDS = (0, 1, 2)
STOKES_NEST_COUNT_TOL = 0.05
SLIP_GATE = 1e-8
NEST_BACKWARD_ERROR_GATE = 1e-8
# LinearProblem on bench.py's P1 problem (make_problem, L = 4 v) with
# pc_type chebyshev, the probe numpy's default_rng(seed).standard_normal(n
# dofs), rtol 1e-6: the JAX package's (min, max) counts on the CPU of an
# H100 host over seeds 0-4, each with the operator scaled by 1, 1 +- 1e-15
# and 1 +- 3e-15 (f32: 1 +- 1.2e-7) and with b changed by 2e-16 and 5e-16
# (f32: 1.2e-7) random relative noise,
#   python3 scripts/jax_krylov_counts.py lattice --n 64 --dtype f64 --ksp bcgs \
#       --seeds 0 1 2 3 4 --perturb=1e-15,-1e-15,3e-15,-3e-15 --perturb-b=2e-16,5e-16
#   (f32: --perturb=1.2e-7,-1.2e-7 --perturb-b=1.2e-7)
N_KRYLOV = 64
# (35 runs each: BiCGStab 23-26 in f64; 20 runs: 32-44 in f32)
# GMRES(30), max_it 1000, runs at N_GMRES, the largest n at which the JAX
# package's GMRES(30) converges within max_it on this problem: on an 8-core
# x86 CPU (JAX 0.9.0), with --ksp gmres --max-it 1000 at seed 0, it takes
# 7, 13, 20, 27, 135, 292, 485, 613, 736 and 879 its at n = 16, 32, 48, 64,
# 80, 88, 96, 104, 112 and 120, and stops unconverged at 1,020 its at
# n = 124 and 128.  Its range at n = 120 is over seeds 0-2, each with b as
# is and with 2e-16 random relative noise (--seeds S --perturb-b=2e-16):
# 874-884 (879, 876, 874; 884, 881, 881).
N_GMRES = 120
JAX_CPU_KRYLOV_ITS = {("bcgs", "f64"): (23, 26), ("bcgs", "f32"): (32, 44), ("gmres", "f64"): (874, 884)}
KRYLOV_SEEDS = (0, 1, 2)
GMRES_MAX_IT = 1000
# demo_periodic_gep at n=128, nev=4 through the JAX package on the CPU
# (JAX 0.9.0): 21 outer iterations, 6,941 inner batched-CG iterations,
# eigenvalues 9.8701, 39.4863, 49.3644, 49.3644, measured with
#   python3 scripts/jax_krylov_counts.py gep --n 128 --nev 4
# (recorded beside the port's counts; the gate is the demo's own, the
# eigenvalues within 1e-6 of scipy's eigsh on the reduced pencil)
N_GEP, NEV_GEP = 128, 4
JAX_CPU_GEP = {"outer": 21, "inner": 6941}
# demo_stokes (16 x 8) GMRES(100) count and the Newton counts of
# demo_stokes_nonlinear_nest (12 x 6) and tests/test_nonlinear.py's periodic
# problem, the JAX package on the CPU (JAX 0.9.0; 3,570, 4 and 5):
#   python3 scripts/jax_krylov_counts.py stokes --nx 16 --ny 8
#   python3 scripts/jax_krylov_counts.py nonlinear_nest --nx 12 --ny 6
#   python3 scripts/jax_krylov_counts.py nonlinear
JAX_CPU_STOKES_GMRES_ITS = 3570
STOKES_GMRES_COUNT_TOL = 0.02
JAX_CPU_NONLINEAR_NEST_ITS = 4
JAX_CPU_NONLINEAR_ITS = 5


def nest_backward_error(A, b, x):
    """|b - A x|_inf / (|A|_inf |x|_inf + |b|_inf) of the nest system, in
    float64 with the CSR blocks' plain product."""
    import numpy as np

    S = A.to_scipy()
    xh, bh = x.double().cpu().numpy(), b.double().cpu().numpy()
    r = bh - S @ xh
    a_inf = float(abs(S).sum(axis=1).max())
    return float(np.abs(r).max() / (a_inf * np.abs(xh).max() + np.abs(bh).max()))


def stokes_nest_path(dev, nx=NX_NEST, ny=NY_NEST, seeds=NEST_SEEDS):
    """Phase 7: demo_stokes_nest's problem at nx x ny in float64 through the
    port's entry points, its nest blocks as BELL operators (every block
    matvec and every matvec of the Chebyshev velocity preconditioner one K8
    launch): nest assembly -> to_bell -> for each probe seed, Chebyshev /
    pressure-mass Jacobi -> bicgstab -> backsubstitution, counters reset
    before and read after.  Returns (counts, summary)."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.demos import demo_stokes_nest as demo
    from dolfinx_mpc_tpu_torch.la.solvers import bicgstab

    reset_counts()
    t0 = time.time()
    pb = demo.problem(nx, ny, device=dev)
    torch.cuda.synchronize()
    t_asm = time.time() - t0
    t0 = time.time()
    A = pb.A.to_bell()
    torch.cuda.synchronize()
    t_bell = time.time() - t0
    nV = pb.V.num_dofs
    runs = []
    for seed in seeds:
        t0 = time.time()
        M = demo.preconditioner(A, pb.mass_q, np.random.default_rng(seed).standard_normal(nV))
        torch.cuda.synchronize()
        t_pc = time.time() - t0
        t0 = time.time()
        x, its, rnorm = bicgstab(A.matvec, pb.rhs, M=M, rtol=1e-10, max_it=4000)
        torch.cuda.synchronize()
        runs.append(dict(seed=seed, its=its, rnorm=rnorm, pc_s=t_pc, solve_s=time.time() - t0, x=x))
    u = pb.mpc.finalized.backsubstitution(runs[0]["x"][:nV])
    torch.cuda.synchronize()
    counts = read_counts(KERNELS)

    finite = all(bool(torch.isfinite(r["x"]).all()) for r in runs)
    uu = u.cpu().numpy().reshape(-1, 2)
    nvals = pb.nh.x.array.cpu().numpy().reshape(-1, 2)
    sb = np.unique(pb.mpc.slaves // 2)
    slip = float(np.abs(np.einsum("bi,bi->b", uu[sb], nvals[sb])).max())
    eta = max(nest_backward_error(pb.A, pb.rhs, r.pop("x")) for r in runs)
    xr = pb.rhs / torch.linalg.vector_norm(pb.rhs)
    blocks = [B for row in A.blocks for B in row if B is not None]
    its = [r["its"] for r in runs]
    solve_s = sum(r["solve_s"] for r in runs)
    summary = dict(nx=nx, ny=ny, dofs=pb.rhs.shape[0], nV=nV, slaves=pb.mpc.num_local_slaves, runs=runs, finite=finite,
                   its=its, mean_its=float(np.mean(its)), bnorm=float(torch.linalg.vector_norm(pb.rhs)),
                   asm_s=t_asm, bell_s=t_bell, pc_s=runs[0]["pc_s"], ms_per_it=1e3 * solve_s / sum(its),
                   slip=slip, eta=eta, nnz=[B.packed.nnz for B in blocks], max_u=float(np.abs(uu).max()),
                   nest_matvec_ms=cuda_ms(lambda: A.matvec(xr), 20), pc_ms=cuda_ms(lambda: M(xr), 20))
    return counts, summary


def lattice_krylov_path(dev, n, dtype, ksp, seeds=KRYLOV_SEEDS):
    """Phase 8: bench.py's P1 problem (make_problem, L = 4 v) through the
    port's LinearProblem with ksp_type `ksp` and pc_type chebyshev (degree
    3, power iteration from numpy's default_rng(seed) probe, one solve per
    seed), rtol 1e-6: K1 assembles the fold operator, every matvec (the
    power iteration's too) is one K2 launch.  Counters reset before
    LinearProblem and read after.  Returns (counts, summary)."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner

    V, bc, mpc, a, _ = make_problem(n, dtype, dev)
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    reset_counts()
    t0 = time.time()
    prob = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={
        "ksp_type": ksp, "pc_type": "chebyshev", "ksp_rtol": 1e-6, "ksp_atol": 1e-12,
        "ksp_max_it": GMRES_MAX_IT if ksp == "gmres" else 10000})
    its, rnorms, times = [], [], []
    for seed in seeds:
        prob.options.cheb_probe = np.random.default_rng(seed).standard_normal(V.num_dofs).astype(dtype)
        u = prob.solve().x.array
        torch.cuda.synchronize()
        its.append(prob.its)
        rnorms.append(prob.rnorm)
        times.append(time.time() - t0)
        t0 = time.time()
    counts = read_counts(("K1", "K2"))
    if not bool(torch.isfinite(u).all()):
        fail(f"Krylov path {ksp} {np.dtype(dtype).name}: the solution is not finite")
    A, b = prob.A, prob.b
    x = mpc.finalized.homogenize(u)  # the solver's iterate: its slave rows are diagval x = 0
    A64 = plain_operator(A, torch.float64)
    x_ref, _, _ = dmt.cg(A64.matvec, b.double(), M=jacobi_preconditioner(A64.diagonal()), rtol=1e-12, atol=0.0,
                         max_it=5000)
    eta, rel_res, fwd = error_gates(A, b, x, x_ref)
    return counts, dict(n=n, dofs=V.num_dofs, dtype=np.dtype(dtype).name, ksp=ksp, its=its,
                        mean_its=float(np.mean(its)), rnorm=rnorms[-1], first_s=times[0], solve_s=times[1:],
                        eta=eta, rel_res=rel_res, fwd=fwd)


def small_paths(dev):
    """Phases 9 and 10: demo_periodic_gep (n=128, nev=4), demo_stokes
    (16 x 8), demo_stokes_nonlinear_nest (12 x 6) and NonlinearProblem on
    tests/test_nonlinear.py's periodic problem, on the card, each with its
    own checks.  Returns {name: (info, host seconds, launches)}."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.demos import demo_periodic_gep, demo_stokes, demo_stokes_nonlinear_nest
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square

    def nonlinear(info):
        V = dmt.functionspace(create_unit_square(8, 8), ("Lagrange", 1))
        bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, y_planes), V)
        mpc = dmt.MultiPointConstraint(V, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
        mpc.finalize()
        u = dmt.Function(V, name="u", device=dev)
        F = dmt.LinearForm(V, lambda v, c: inner((1 + c["u"].value ** 2) * grad(c["u"]), grad(v)) - 4.0 * v.value,
                           coefficients={"u": u})
        its, converged = dmt.NonlinearProblem(F, u, mpc, bcs=[bc]).solve()
        arr = u.x.array.cpu().numpy()
        xy = V.dof_coords_blocks
        lft, rgt = np.flatnonzero(np.isclose(xy[:, 0], 0.0)), np.flatnonzero(np.isclose(xy[:, 0], 1.0))
        gap = np.abs(arr[lft[np.argsort(xy[lft, 1])]] - arr[rgt[np.argsort(xy[rgt, 1])]]).max()
        if not (converged and gap < 1e-9 and arr.max() > 0.1 and u.x.array.device.type == "cuda"):
            fail(f"NonlinearProblem on the card: converged {converged}, periodicity gap {gap:.3e}")
        info.update(its=its, converged=converged, max_u=float(arr.max()), periodic_gap=float(gap))

    runs = {}
    for name, fn in ((f"demo_periodic_gep.main(n={N_GEP}, nev={NEV_GEP})",
                      lambda i: demo_periodic_gep.main(n=N_GEP, nev=NEV_GEP, device=dev, info=i)),
                     ("demo_stokes.main(nx=16, ny=8)", lambda i: demo_stokes.main(nx=16, ny=8, device=dev, info=i)),
                     ("demo_stokes_nonlinear_nest.main(nx=12, ny=6)",
                      lambda i: demo_stokes_nonlinear_nest.main(nx=12, ny=6, device=dev, info=i)),
                     ("NonlinearProblem, tests/test_nonlinear.py's periodic problem", nonlinear)):
        info = {}
        reset_counts()
        t0 = time.time()
        fn(info)
        torch.cuda.synchronize()
        runs[name] = (info, time.time() - t0, read_counts(KERNELS))
    return runs


def _within(mean, lo_hi, margin, relative):
    """(lo, hi) of the reference range widened by the margin, and whether
    the mean lies inside."""
    lo, hi = lo_hi
    lo, hi = (lo * (1 - margin), hi * (1 + margin)) if relative else (lo - margin, hi + margin)
    return lo, hi, lo <= mean <= hi


def slice10_phases(dev):
    """Phases 7-10 with their gates and report lines.  Returns the counts
    for the kernels line."""
    import numpy as np

    counts7, s7 = stokes_nest_path(dev)
    lattice7 = {k: v for k, v in counts7.items() if k != "K8"}
    # per solve: 3 (the initial residual) + 21 (power iteration) + 16 per
    # iteration (two nest matvecs, two Chebyshev(5) applications)
    k8_expected = sum(3 + 21 + 16 * i for i in s7["its"])
    ref = (min(JAX_CPU_STOKES_NEST_ITS), max(JAX_CPU_STOKES_NEST_ITS))
    lo, hi, ok = _within(s7["mean_its"], ref, STOKES_NEST_COUNT_TOL, relative=True)
    rnorms = ", ".join(f"{r['rnorm']:.3e}" for r in s7["runs"])
    solves = ", ".join(f"{r['solve_s']:.3f}" for r in s7["runs"])
    print(f"nest Stokes path {s7['nx']} x {s7['ny']} ({s7['dofs']} dofs, {s7['nV']} velocity, {s7['slaves']} slip "
          f"slaves, f64; BELL blocks {s7['nnz']} nonzeros): nest assembly + rhs + pressure mass {s7['asm_s']:.2f} s, "
          f"BELL conversion {s7['bell_s']:.2f} s, preconditioner set-up (21 power-iteration matvecs) {s7['pc_s']:.3f} s, "
          f"BiCGStab {s7['its']} its at probe seeds {list(NEST_SEEDS)} (mean {s7['mean_its']:.1f}; JAX CPU over seeds "
          f"0-4, b as assembled and changed by 2e-16: {list(JAX_CPU_STOKES_NEST_ITS)}, gate [{lo:.0f}, {hi:.0f}]) in [{solves}] s, "
          f"{s7['ms_per_it']:.4f} ms/it, rnorm [{rnorms}] (|b| {s7['bnorm']:.3e}), nest matvec (3 K8 launches) {s7['nest_matvec_ms']:.4f} ms, preconditioner (5 K8) "
          f"{s7['pc_ms']:.4f} ms; max|u.n| on the slip wall {s7['slip']:.3e} (gate {SLIP_GATE:g}), backward error "
          f"{s7['eta']:.3e} (gate {NEST_BACKWARD_ERROR_GATE:g}), max|u| {s7['max_u']:.4f}; launches {counts7} "
          f"({k8_expected} expected)", flush=True)
    if not s7["finite"]:
        fail("nest Stokes path: a solution is not finite")
    if counts7["K8"] != k8_expected or max(lattice7.values()) != 0:
        fail(f"nest Stokes path: K8 must launch 3 + 21 + 16 its per solve = {k8_expected} times and no lattice "
             f"kernel: {counts7}")
    if not s7["slip"] <= SLIP_GATE:
        fail(f"nest Stokes path: max|u.n| {s7['slip']:.3e} > {SLIP_GATE:g}")
    if not s7["eta"] <= NEST_BACKWARD_ERROR_GATE:
        fail(f"nest Stokes path: backward error {s7['eta']:.3e} > {NEST_BACKWARD_ERROR_GATE:g}")
    if not ok:
        fail(f"nest Stokes BiCGStab mean {s7['mean_its']:.1f} its outside [{lo:.0f}, {hi:.0f}]")

    krylov = {}
    for ksp, dtype, n in (("bcgs", np.float64, N_KRYLOV), ("bcgs", np.float32, N_KRYLOV),
                          ("gmres", np.float64, N_GMRES)):
        c8, s8 = lattice_krylov_path(dev, n, dtype, ksp)
        key = (ksp, {"float64": "f64", "float32": "f32"}[s8["dtype"]])
        single = key[1] == "f32"
        lo, hi, ok = _within(s8["mean_its"], JAX_CPU_KRYLOV_ITS[key], 0.1 if single else 2, relative=single)
        print(f"Krylov path {ksp} + Chebyshev, P1 n={s8['n']} ({s8['dofs']} dofs, {s8['dtype']}) through "
              f"LinearProblem: {s8['its']} its at probe seeds {list(KRYLOV_SEEDS)} (mean {s8['mean_its']:.1f}; JAX "
              f"CPU range {JAX_CPU_KRYLOV_ITS[key]}, gate [{lo:.1f}, {hi:.1f}]), first solve with assembly "
              f"{s8['first_s']:.3f} s, then {[round(t, 3) for t in s8['solve_s']]} s, rnorm {s8['rnorm']:.3e}; "
              f"recomputed in f64: |b-Ax|/|b| {s8['rel_res']:.3e}, backward error {s8['eta']:.3e} (gate "
              f"{BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s8['fwd']:.3e} (gate {FORWARD_ERROR_GATE:g}); launches "
              f"{c8}", flush=True)
        if c8["K1"] <= 0 or c8["K2"] <= 0:
            fail(f"Krylov path {key}: K1 and K2 must launch: {c8}")
        if not s8["eta"] <= BACKWARD_ERROR_GATE or not s8["fwd"] <= FORWARD_ERROR_GATE:
            fail(f"Krylov path {key}: backward error {s8['eta']:.3e} / forward error {s8['fwd']:.3e}")
        if not ok:
            fail(f"Krylov path {key}: mean {s8['mean_its']:.1f} its outside [{lo:.1f}, {hi:.1f}]")
        if ksp == "gmres" and not max(s8["its"]) < GMRES_MAX_IT:
            fail(f"Krylov path {key}: GMRES(30) did not converge within {GMRES_MAX_IT} its: {s8['its']}")
        krylov[key] = c8

    runs = small_paths(dev)
    for name, (info, secs, c) in runs.items():
        shown = {k: v for k, v in info.items() if k != "rel"}
        if "rel" in info:
            shown["max_rel_eigenvalue_error"] = float(np.max(info["rel"]))
        print(f"{name} on the card: its own checks passed in {secs:.2f} s; {shown}; launches {c}", flush=True)
    (gep, _, _), (stokes, _, _), (nnest, _, _), (nl, _, _) = runs.values()
    print(f"eigensolver counts: outer {gep['outer']}, inner {gep['inner']} (JAX CPU: outer {JAX_CPU_GEP['outer']}, "
          f"inner {JAX_CPU_GEP['inner']})", flush=True)
    if abs(stokes["its"] - JAX_CPU_STOKES_GMRES_ITS) > STOKES_GMRES_COUNT_TOL * JAX_CPU_STOKES_GMRES_ITS:
        fail(f"demo_stokes GMRES took {stokes['its']} its, JAX-CPU takes {JAX_CPU_STOKES_GMRES_ITS} "
             f"(+-{STOKES_GMRES_COUNT_TOL:.0%} allowed)")
    if nnest["its"] != JAX_CPU_NONLINEAR_NEST_ITS or nl["its"] != JAX_CPU_NONLINEAR_ITS:
        fail(f"Newton counts {nnest['its']} (nest) and {nl['its']} (periodic), JAX-CPU takes "
             f"{JAX_CPU_NONLINEAR_NEST_ITS} and {JAX_CPU_NONLINEAR_ITS}")
    return counts7, krylov


# ---- slice 11: the rest of the lattice path (phase 11): the "csr" and
# ---- "cells" side formats, the element-kernel paths, GMG's options

# Counts of the JAX package on the CPU of an H100 host (JAX 0.9.0), as
# (min, max) over the seeds FORMAT_SEEDS, each as assembled (11a: b times
# 1 + 1.2e-7 r in float32, 1 + 2e-16 r in float64) and with b changed by
# rounding-level random relative noise, from
# scripts/jax_lattice_format_counts.py (commands beside each).  A port count
# is gated as phase 8's: the mean over FORMAT_SEEDS must lie in the range
# widened by 2 its (float64) or 10 % (float32 Chebyshev-CG) — the card's
# atomics move counts by rounding (PERF.md §6).  In float32 the JAX
# package's CPU dot products of 274,625 values accumulate in sequence,
# whose error grows with n: its CG then needs more iterations than the
# port's (19 against 16 for 11a, 202-207 against 158 for 11b), and the port
# with a sequential float32 dot product takes the JAX count (13 for the JAX
# package's 13 at 11a's n=32 on the CPU, 12 with torch's own dot product:
# python3 scripts/cg_dot_order.py --n 32).  So the float32
# counts of 11a and 11b are gated from above only (the port may need fewer
# iterations, not more), and their float64 counts, where both packages'
# arithmetic is accurate, both ways.
FORMAT_SEEDS = (0, 1, 2)
# 11a: bench.py's P1 problem at n=64 (274,625 dofs), "cells" levels,
# tests/test_gmg.py's LatticeGMG, cg rtol 1e-6:
#   python3 scripts/jax_lattice_format_counts.py cells_gmg --n 64 --seeds 0 1 2 --perturb-b=5e-7
#   (float64: --dtype float64 --perturb-b=5e-16)
N_FORMATS = 64
JAX_CPU_CELLS_GMG_ITS = {"float32": (19, 19), "float64": (14, 14)}
# 11b: inner(kappa grad u, grad v), kappa = 1 + x0 x1 in P1, n=64,
# LinearProblem (fold) with cg + Chebyshev, rtol 1e-6:
#   python3 scripts/jax_lattice_format_counts.py coefficient --n 64 --seeds 0 1 2 --perturb-b=1.2e-7
#   (float64: --dtype float64 --perturb-b=2e-16)
JAX_CPU_COEFFICIENT_ITS = {"float32": (202, 207), "float64": (158, 158)}
# 11c: demo_periodic_geometrical's problem at n=512 (263,169 dofs), float64,
# LinearProblem (fold) with cg + Chebyshev, rtol 1e-12:
#   python3 scripts/jax_lattice_format_counts.py square --n 512 --seeds 0 1 2 --perturb-b=2e-16
N_SQUARE = 512
JAX_CPU_SQUARE_ITS = (810, 810)
# 2-D P2 (K6 at s2 = 1) and 2-D vector P1 (K7 at bs = 2) operators of the
# 11c kernel checks: (2 N_SQUARE_P2 + 1)^2 and (N_SQUARE + 1)^2 x 2 dofs
N_SQUARE_P2 = 256
# 11d: vector P2 elasticity at n=16 (107,811 dofs), float64, cg + Chebyshev,
# rtol 1e-10 (the JAX package's general assembler: it has no fold operator
# for a vector space at degree 2; the port runs its fold operator):
#   python3 scripts/jax_lattice_format_counts.py p2_elasticity --n 16 --seeds 0 1 2 --perturb-b=2e-16
N_P2_ELASTICITY, N_P2_ELASTICITY_JAX = 32, 16
JAX_CPU_P2_ELASTICITY_ITS = (258, 260)
SIDE_GATE = 5e-6


def _seed_vectors(n, dtype, dev):
    import numpy as np
    import torch

    return [torch.as_tensor(np.random.default_rng(s).standard_normal(n).astype(dtype), device=dev)
            for s in FORMAT_SEEDS]


def _b_noise(b, seed, eps):
    """b times (1 + eps r), r from numpy's default_rng(1000 + seed): the
    JAX count script's rounding-level change of b."""
    import numpy as np
    import torch

    r = np.random.default_rng(1000 + seed).standard_normal(b.shape[0])
    return b * torch.as_tensor(1 + eps * r, dtype=b.dtype, device=b.device)


def side_formats_path(dev, n=N_FORMATS):
    """11a: bench.py's P1 problem in float32 on the "csr" and "cells" side
    formats: each operator's matvec and diagonal against the fold
    operator's, the side products' device time per matvec, then
    tests/test_gmg.py's preconditioner over "cells" levels (4 levels,
    LatticeGMG's defaults) and cg to rtol 1e-6, one solve per seed, b
    changed by 1.2e-7 relative noise; the main path's error gates on seed
    0's solution; then the same GMG-CG in float64 (b changed by 2e-16), the
    count the JAX package's CPU arithmetic reproduces.  Counters reset
    before the assembly, read after the solves."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner

    V, bc, mpc, a, clf_fold = make_problem(n, np.float32, dev)
    A_fold = clf_fold.assemble()
    reset_counts()
    ops, asm_s = {}, {}
    for fmt in ("csr", "cells"):
        torch.cuda.synchronize()
        t0 = time.time()
        ops[fmt] = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=np.float32, side_format=fmt,
                                               device=dev).assemble()
        torch.cuda.synchronize()
        asm_s[fmt] = time.time() - t0
    mv_err = {f: max(_rel_l2(A.matvec(x), A_fold.matvec(x)) for x in _seed_vectors(V.num_dofs, np.float32, dev))
              for f, A in ops.items()}
    d_err = {f: _rel_l2(A.diagonal(), A_fold.diagonal()) for f, A in ops.items()}
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    b0 = dmt.set_bc(dmt.assemble_vector(L, mpc), [bc])
    t0 = time.time()
    levels, masks = dmt.build_gmg_hierarchy(lambda m: make_problem(m, np.float32, dev, side_format="cells")[4],
                                            n, 4, min_n=8)
    levels[0] = ops["cells"]
    M = dmt.LatticeGMG(levels, free_masks=masks)
    torch.cuda.synchronize()
    gmg_s = time.time() - t0
    runs = []
    for seed in FORMAT_SEEDS:
        b = _b_noise(b0, seed, 1.2e-7)
        t0 = time.time()
        x, its, rnorm = dmt.cg(ops["cells"].matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
        torch.cuda.synchronize()
        runs.append(dict(its=its, rnorm=rnorm, s=time.time() - t0, x=x, b=b))
    V64, bc64, mpc64, a64, clf64 = make_problem(n, np.float64, dev, side_format="cells")
    b64 = dmt.set_bc(dmt.assemble_vector(dmt.LinearForm(V64, lambda v, c: 4.0 * v.value), mpc64), [bc64])
    levels64, masks64 = dmt.build_gmg_hierarchy(
        lambda m: make_problem(m, np.float64, dev, side_format="cells")[4], n, 4, min_n=8)
    M64 = dmt.LatticeGMG(levels64, free_masks=masks64)
    its64 = [dmt.cg(levels64[0].matvec, _b_noise(b64, seed, 2e-16), M=M64, rtol=1e-6, atol=1e-12, max_it=3000)[1]
             for seed in FORMAT_SEEDS]
    counts = read_counts(("K2",))
    A = ops["cells"]
    A64 = plain_operator(A, torch.float64)
    x_ref, _, _ = dmt.cg(A64.matvec, runs[0]["b"].double(), M=jacobi_preconditioner(A64.diagonal()), rtol=1e-12,
                         atol=0.0, max_it=5000)
    eta, rel_res, fwd = error_gates(A, runs[0]["b"], runs[0]["x"], x_ref)
    xr = b0 / torch.linalg.vector_norm(b0)
    times = {f: dict(matvec_ms=cuda_ms(lambda: B.matvec(xr), 50), dia_ms=cuda_ms(lambda: B.dia.matvec(xr), 50),
                     side_ms=cuda_ms(lambda: B._add_side(xr, torch.zeros_like(xr)), 50)) for f, B in ops.items()}
    its = [r["its"] for r in runs]
    n_sc = int(A.side_Aep.shape[0])
    return counts, dict(n=n, dofs=V.num_dofs, mv_err=mv_err, d_err=d_err, asm_s=asm_s, gmg_s=gmg_s,
                        levels=[o.dia.vshape for o in levels], its=its, mean_its=float(np.mean(its)), its64=its64,
                        rnorm=runs[0]["rnorm"], solve_s=[r["s"] for r in runs], eta=eta, rel_res=rel_res, fwd=fwd,
                        times=times, n_sc=n_sc, W=int(A.side_Aep.shape[1]), nnz=int(ops["csr"].side_data.shape[0]))


def coefficient_path(dev, n=N_FORMATS):
    """11b: inner(kappa grad u, grad v), kappa = 1 + x0 x1 in P1, on
    bench.py's mesh and constraint in float32 through LinearProblem (the
    fold format's element-kernel path: the kernel on the real cell
    coordinates with kappa gathered per cell), cg + Chebyshev (one solve
    per probe seed), rtol 1e-6; the operator's matvec against the general
    assembler's MPCMatrix on the card; the element kernel's time on every
    cell; then the same solves in float64, the count the JAX package's CPU
    arithmetic reproduces.  Counters reset before LinearProblem, read after
    the solves."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.ops.assemble import _coeff_vectors

    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, y_planes), V)
    kappa = dmt.Function(V, device=dev)
    kappa.interpolate(lambda x: 1.0 + x[0] * x[1])
    a = dmt.BilinearForm(V, lambda u, v, c: c["kappa"].value * inner(grad(u), grad(v)), coefficients={"kappa": kappa})
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)

    def solves(dtype):
        mpc = dmt.MultiPointConstraint(V, dtype, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
        mpc.finalize()
        t0 = time.time()
        prob = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={
            "ksp_type": "cg", "pc_type": "chebyshev", "ksp_rtol": 1e-6, "ksp_atol": 1e-12})
        its, times = [], []
        for seed in FORMAT_SEEDS:
            prob.options.cheb_probe = np.random.default_rng(seed).standard_normal(V.num_dofs).astype(dtype)
            u = prob.solve().x.array
            torch.cuda.synchronize()
            its.append(prob.its)
            times.append(time.time() - t0)
            t0 = time.time()
        return mpc, prob, u, its, times

    reset_counts()
    mpc, prob, u, its, times = solves(np.float32)
    its64 = solves(np.float64)[3]
    counts = read_counts(KERNELS)
    A, b = prob.A, prob.b
    if getattr(A, "fold_axis", None) is None:
        fail(f"coefficient path: LinearProblem took {type(A).__name__}, not the fold operator")
    G = dmt.assemble_matrix(a, mpc, bcs=[bc], dtype=np.float32, device=dev)
    mv_err = max(_rel_l2(A.matvec(x), G.matvec(x)) for x in _seed_vectors(V.num_dofs, np.float32, dev))
    x = mpc.finalized.homogenize(u)
    A64 = plain_operator(A, torch.float64)
    x_ref, _, _ = dmt.cg(A64.matvec, b.double(), M=jacobi_preconditioner(A64.diagonal()), rtol=1e-12, atol=0.0,
                         max_it=5000)
    eta, rel_res, fwd = error_gates(A, b, x, x_ref)
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=np.float32, side_format="fold", device=dev)
    wl = {k: _coeff_vectors(clf.term, dev)[k][dm] for k, dm in clf._wdofmaps.items()}
    kernel_ms = cuda_ms(lambda: clf._element_tensors(clf._coords, wl), 3, 1)
    lattice_ms = cuda_ms(lambda: clf.assemble(), 3, 1)
    general_ms = cuda_ms(lambda: dmt.assemble_matrix(a, mpc, bcs=[bc], dtype=np.float32, device=dev), 3, 1)
    return counts, dict(n=n, dofs=V.num_dofs, cells=V.mesh.num_cells, its=its, mean_its=float(np.mean(its)), its64=its64,
                        first_s=times[0], solve_s=times[1:], rnorm=prob.rnorm, mv_err=mv_err, eta=eta,
                        rel_res=rel_res, fwd=fwd, kernel_ms=kernel_ms, lattice_ms=lattice_ms, general_ms=general_ms)


def _spmv_check(name, A, gen, dev, counter_name):
    """A lattice operator's DIA (K2 / K7) or blocked (K6) part against its
    plain version on the card in float32 and float64 (relative L2 <= 5e-6
    and 1e-12), one counted launch each, with the f32 warm and profiler
    device times, the plain version's and the bound.  Returns the f32
    numbers."""
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

    dia = A.dia
    out = {}
    for dt, tol in ((torch.float32, 5e-6), (torch.float64, 1e-12)):
        data = dia.data.to(dt).contiguous()
        if counter_name == "K6":
            x = torch.randn((len(dia.classes),) + dia.cdims, generator=gen, device=dev, dtype=torch.float64).to(dt)
            run = lambda: LK.blocked_matvec(data, dia.trips, dia.classes, x)  # noqa: E731
            plain = lambda: LK.blocked_matvec_plain(data, dia.trips, dia.classes, x)  # noqa: E731
        else:
            x = torch.randn(dia.shape[0], generator=gen, device=dev, dtype=torch.float64).to(dt)
            run = ((lambda: LK.dia_matvec(data, dia.offsets, dia.vshape, x)) if dia.bs == 1  # noqa: E731
                   else (lambda: LK.dia_matvec_bs(data, dia.offsets, dia.vshape, dia.bs, x)))
            plain = lambda: LK.dia_matvec_plain(data, dia.offsets, dia.vshape, dia.bs, x)  # noqa: E731
        n0 = wrapper(counter_name).launches
        got = run()
        torch.cuda.synchronize()
        if wrapper(counter_name).launches != n0 + 1:
            fail(f"{name}: {counter_name} did not launch once")
        ref = plain()
        rel = _rel_l2(got, ref)
        if not rel <= tol:
            fail(f"{name}: {counter_name} disagrees with its plain version in {dt}: {rel:.3e} > {tol:g}")
        if dt == torch.float32:
            bms, by = spmv_bound(data.numel(), x, got)
            kernel = "blocked_matvec_kernel" if counter_name == "K6" else "dia_matvec_kernel"
            out = dict(err=rel, max_abs_err=float((got - ref).abs().max()), ms=cuda_ms(run, 50),
                       device_ms=profiler_ms(run, 50, kernel), plain_ms=cuda_ms(plain, 5), bound_ms=bms, bound_by=by)
        else:
            out["err64"] = rel
    return out


def square_path(dev, gen, n=N_SQUARE, n_p2=N_SQUARE_P2):
    """11c: demo_periodic_geometrical's problem on the n x n square in
    float64 through LinearProblem (the fold format's element-kernel lean
    path, K2 on the n2 = 1 grid) with cg + Chebyshev, one solve per probe
    seed, rtol 1e-12; then a 2-D P2 problem on the n_p2 square (the
    parity-blocked fold operator, K6 at s2 = 1) and 2-D vector P1
    elasticity on the n square (K7 at bs = 2, n2 = 1) through LinearProblem
    with Jacobi-CG to rtol 1e-8; counters reset before each and read after.
    Then each kernel on its operator against its plain version."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square

    def problem(m, degree=1, bs=None):
        V = dmt.functionspace(create_unit_square(m, m), ("Lagrange", degree, (bs,)) if bs else ("Lagrange", degree))
        bc = dmt.dirichletbc(np.zeros(bs) if bs else 0.0, dmt.locate_dofs_geometrical(V, y_planes), V)
        mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
        mpc.finalize()
        return V, bc, mpc

    V, bc, mpc = problem(n)
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    L = dmt.LinearForm(V, lambda v, c: (c.x[0] * torch.sin(5.0 * np.pi * c.x[1])
                                        + torch.exp(-((c.x[0] - 0.5) ** 2 + (c.x[1] - 0.5) ** 2) * 50.0)) * v.value)
    reset_counts()
    t0 = time.time()
    prob = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={
        "ksp_type": "cg", "pc_type": "chebyshev", "ksp_rtol": 1e-12})
    its, times = [], []
    for seed in FORMAT_SEEDS:
        prob.options.cheb_probe = np.random.default_rng(seed).standard_normal(V.num_dofs)
        u = prob.solve().x.array
        torch.cuda.synchronize()
        its.append(prob.its)
        times.append(time.time() - t0)
        t0 = time.time()
    counts = {"P1": read_counts(KERNELS)}
    A = prob.A
    if getattr(A, "fold_axis", None) is None or A.dia.vshape[2] != 1:
        fail(f"2-D path: LinearProblem took {type(A).__name__}, not the 2-D fold operator")
    if not bool(torch.isfinite(u).all()):
        fail("2-D path: the solution is not finite")
    ops, solves = {"K2": A}, {}
    for key, m, degree, bs in (("K6", n_p2, 2, None), ("K7", n, 1, 2)):
        Vk, bck, mpck = problem(m, degree, bs)
        if bs:
            ak = dmt.BilinearForm(Vk, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v)))
                                  + 1.25 * div(u) * conj(div(v)))
            Lk = dmt.LinearForm(Vk, lambda v, c: c.x[0] * v.value[..., 0] - v.value[..., 1])
        else:
            ak = dmt.BilinearForm(Vk, lambda u, v, c: inner(grad(u), grad(v)))
            Lk = dmt.LinearForm(Vk, lambda v, c: (1.0 + c.x[0] * c.x[1]) * v.value)
        reset_counts()
        t0 = time.time()
        pk = dmt.LinearProblem(ak, Lk, mpck, bcs=[bck], petsc_options={
            "ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-8, "ksp_max_it": 20000})
        uk = pk.solve().x.array
        torch.cuda.synchronize()
        counts["P2" if key == "K6" else "vector P1"] = read_counts(KERNELS)
        if getattr(pk.A, "fold_axis", None) is None or not bool(torch.isfinite(uk).all()) or pk.its >= 20000:
            fail(f"2-D path {key}: {type(pk.A).__name__}, {pk.its} its, finite {bool(torch.isfinite(uk).all())}")
        ops[key] = pk.A
        solves[key] = dict(dofs=Vk.num_dofs, its=pk.its, s=time.time() - t0, rnorm=pk.rnorm)
    checks = {k: _spmv_check(f"2-D {k}", B, gen, dev, k) for k, B in ops.items()}
    shapes = dict(K2=A.dia.vshape, K6=(len(ops["K6"].dia.classes),) + ops["K6"].dia.cdims,
                  K7=ops["K7"].dia.vshape + (2,))
    return counts, dict(n=n, n_p2=n_p2, dofs=V.num_dofs, its=its, mean_its=float(np.mean(its)), first_s=times[0],
                        solve_s=times[1:], rnorm=prob.rnorm, checks=checks, shapes=shapes, solves=solves)


def p2_elasticity_path(dev, gen, n=N_P2_ELASTICITY, check=True):
    """11d: linear elasticity (mu = 1, lambda = 1.25, quad_degree 2) in
    ("Lagrange", 2, (3,)) on bench.py's mesh and constraint, float64, on
    the fold format (the element-kernel lean path onto the refined grid,
    65 offsets, halo 2): assemble_matrix_lattice -> assemble_vector +
    apply_lifting + set_bc -> cg + Chebyshev to rtol 1e-10, one solve per
    probe seed, counters reset before and read after; the main path's
    error gates on seed 0's solution; with `check`, K7 on that operator
    against its plain version."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu_torch.la.solvers import chebyshev_preconditioner

    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 2, (3,)))
    bc = dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, y_planes), V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)),
                         quad_degree=2)
    L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0] + 0.5 * c.x[1] * v.value[..., 1]
                       - v.value[..., 2])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    A = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], side_format="fold", device=dev).assemble()
    b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [[bc]], mpc), [bc])
    torch.cuda.synchronize()
    asm_s = time.time() - t0
    runs = []
    for seed in FORMAT_SEEDS:
        t0 = time.time()
        M = chebyshev_preconditioner(A.matvec, A.diagonal(), probe=np.random.default_rng(seed).standard_normal(
            V.num_dofs))
        x, its, rnorm = dmt.cg(A.matvec, b, M=M, rtol=1e-10, max_it=10000)
        torch.cuda.synchronize()
        runs.append(dict(its=its, rnorm=rnorm, s=time.time() - t0, x=x))
    counts = read_counts(("K7", "K2"))
    by_grid = dict(wrapper("K7").launches_by_grid)
    its = [r["its"] for r in runs]
    out = dict(n=n, dofs=V.num_dofs, offsets=len(A.dia.offsets), vshape=A.dia.vshape, asm_s=asm_s, its=its,
               mean_its=float(np.mean(its)), rnorm=runs[0]["rnorm"], solve_s=[r["s"] for r in runs], by_grid=by_grid)
    if check:
        M = chebyshev_preconditioner(A.matvec, A.diagonal(), probe=np.random.default_rng(0).standard_normal(V.num_dofs))
        x_ref, _, _ = dmt.cg(A.matvec, b, M=M, rtol=1e-13, atol=0.0, max_it=20000)
        out["eta"], out["rel_res"], out["fwd"] = error_gates(A, b, runs[0]["x"], x_ref)
        out["K7"] = _spmv_check(f"vector P2 n={n}", A, gen, dev, "K7")
        out["data_mb"] = A.dia.data.numel() * A.dia.data.element_size() / 1e6
    return counts, out


def oracle_lattice_f64(dev, kind):
    """11e: float64 on the card against u = K (K^T A K)^-1 K^T b from scipy:
    "csr" and "cells" (P1 n=6, the operator of that format, Jacobi-CG,
    backsubstitution), the coefficient form on fold and the 2-D periodic
    square (LinearProblem, Jacobi-CG) and vector P2 elasticity on fold
    (n=3).  Returns (max error, CG iterations, launches)."""
    import numpy as np
    import scipy.sparse.linalg as spla

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube, create_unit_square
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix

    bs = 3 if kind == "vector P2" else None
    degree = 2 if kind == "vector P2" else 1
    mesh = (create_unit_square(12, 12) if kind == "2-D" else
            create_unit_cube(3, 3, 3) if kind == "vector P2" else create_unit_cube(6, 6, 6))
    V = dmt.functionspace(mesh, ("Lagrange", degree, (bs,)) if bs else ("Lagrange", degree))
    bc = dmt.dirichletbc(np.zeros(bs) if bs else 0.0, dmt.locate_dofs_geometrical(V, y_planes), V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
    rel = (lambda x: np.stack([1.0 - x[0], x[1]])) if kind == "2-D" else (lambda x: np.stack([1.0 - x[0], x[1], x[2]]))
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0), rel, [bc])
    mpc.finalize()
    if kind == "vector P2":
        a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)),
                             quad_degree=2)
        L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0] - v.value[..., 2])
    elif kind == "coefficient fold":
        kappa = dmt.Function(V, device=dev)
        kappa.interpolate(lambda x: 1.0 + x[0] * x[1])
        a = dmt.BilinearForm(V, lambda u, v, c: c["kappa"].value * inner(grad(u), grad(v)),
                             coefficients={"kappa": kappa})
        L = dmt.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0] * c.x[2]) * v.value)
    else:
        a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
        L = dmt.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0] * c.x[1]) * v.value)
    reset_counts()
    if kind in ("coefficient fold", "2-D"):
        prob = dmt.LinearProblem(a, L, mpc, bcs=[bc],
                                 petsc_options={"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12})
        u, its = prob.solve().x.array, prob.its
        if getattr(prob.A, "fold_axis", None) is None:
            fail(f"f64 oracle {kind}: LinearProblem did not take the fold operator")
    else:
        fmt = "fold" if kind == "vector P2" else kind
        A = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], side_format=fmt, device=dev).assemble()
        b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [[bc]], mpc), [bc])
        x, its, _ = dmt.cg(A.matvec, b, M=jacobi_preconditioner(A.diagonal()), rtol=1e-12, max_it=20000)
        u = mpc.finalized.backsubstitution(x)
    counts = read_counts(KERNELS)
    A = assemble_matrix_scipy(a, [bc])
    b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, None, device="cpu"), [a], [[bc]], None, device="cpu"),
                   [bc]).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)
    return float(np.abs(u.cpu().numpy() - u_ref).max()), its, counts


def _count_gate(name, its, ref, relative, from_above=False):
    """Print-ready text of a count gate and fail if the mean is outside the
    JAX range widened by 10 % (relative) or else by 2 its (from_above: only
    above it)."""
    import numpy as np

    mean = float(np.mean(its))
    if ref is None:
        fail(f"{name}: no JAX CPU count recorded")
    lo, hi, ok = _within(mean, ref, 0.1 if relative else 2, relative=relative)
    if from_above:
        lo, ok = 0.0, mean <= hi
    if not ok:
        fail(f"{name}: mean {mean:.1f} its outside [{lo:.1f}, {hi:.1f}] (JAX CPU {ref})")
    return f"{its} its at seeds {list(FORMAT_SEEDS)} (mean {mean:.1f}; JAX CPU {ref}, gate [{lo:.1f}, {hi:.1f}])"


def _gates(name, s):
    if not s["eta"] <= BACKWARD_ERROR_GATE or not s["fwd"] <= FORWARD_ERROR_GATE:
        fail(f"{name}: backward error {s['eta']:.3e} / forward error {s['fwd']:.3e}")
    return (f"recomputed in f64: |b-Ax|/|b| {s['rel_res']:.3e}, backward error {s['eta']:.3e} (gate "
            f"{BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s['fwd']:.3e} (gate {FORWARD_ERROR_GATE:g})")


def _check_text(c):
    dev = "not measured" if c["device_ms"] is None else f"{c['device_ms']:.4f} ms"
    return (f"rel L2 {c['err']:.3e} (f32, tol 5e-06) / {c['err64']:.3e} (f64, tol 1e-12), {c['ms']:.4f} ms warm, "
            f"device {dev}, plain {c['plain_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms ({c['bound_by']})")


def slice11_phases(dev, gen):
    """Phase 11 with its gates and report lines.  Returns the launches of
    K2, K6 and K7 by sub-phase and the kernel checks, for the kernels
    line."""
    launches = {"K2": {}, "K6": {}, "K7": {}}
    c, s = side_formats_path(dev)
    t = s["times"]
    print(f"11a side formats, P1 n={s['n']} ({s['dofs']} dofs, f32; {s['n_sc']} slave cells of width {s['W']}, "
          f"{s['nnz']} csr side entries): assembly csr {s['asm_s']['csr']:.2f} s, cells {s['asm_s']['cells']:.2f} s "
          f"(host tables included); matvec vs fold: csr {s['mv_err']['csr']:.2e}, cells {s['mv_err']['cells']:.2e}, "
          f"diagonal csr {s['d_err']['csr']:.2e}, cells {s['d_err']['cells']:.2e} (gate {SIDE_GATE:g}); matvec "
          f"csr {t['csr']['matvec_ms']:.4f} ms = DIA (K2) {t['csr']['dia_ms']:.4f} + side product "
          f"{t['csr']['side_ms']:.4f} ms, cells {t['cells']['matvec_ms']:.4f} = {t['cells']['dia_ms']:.4f} + "
          f"{t['cells']['side_ms']:.4f} ms; GMG over cells levels {s['levels']} built in {s['gmg_s']:.2f} s, CG "
          + _count_gate("11a cells GMG-CG f32", s["its"], JAX_CPU_CELLS_GMG_ITS["float32"], False, from_above=True)
          + f" in {[round(v, 3) for v in s['solve_s']]} s, rnorm {s['rnorm']:.3e}; " + _gates("11a", s)
          + "; in f64 " + _count_gate("11a cells GMG-CG f64", s["its64"], JAX_CPU_CELLS_GMG_ITS["float64"], False)
          + f"; launches {c}", flush=True)
    if max(max(s["mv_err"].values()), max(s["d_err"].values())) > SIDE_GATE:
        fail(f"11a: a side format disagrees with the fold operator: {s['mv_err']}, {s['d_err']}")
    if c["K2"] <= 0:
        fail(f"11a: K2 did not launch: {c}")
    launches["K2"]["11a"] = c["K2"]

    c, s = coefficient_path(dev)
    print(f"11b coefficient form on fold, P1 n={s['n']} ({s['dofs']} dofs, f32) through LinearProblem, cg + "
          f"Chebyshev: " + _count_gate("11b coefficient cg f32", s["its"], JAX_CPU_COEFFICIENT_ITS["float32"], True,
                                       from_above=True)
          + "; in f64 " + _count_gate("11b coefficient cg f64", s["its64"], JAX_CPU_COEFFICIENT_ITS["float64"], False)
          + f", first solve with assembly {s['first_s']:.2f} s, then {[round(v, 3) for v in s['solve_s']]} s, rnorm "
          f"{s['rnorm']:.3e}; matvec vs the general assembler's MPCMatrix {s['mv_err']:.2e} (gate {SIDE_GATE:g}); "
          f"element kernel on {s['cells']} cells {s['kernel_ms']:.2f} ms, the lattice assembly {s['lattice_ms']:.2f} "
          f"ms, the general assembler {s['general_ms']:.2f} ms; " + _gates("11b", s) + f"; launches {c}", flush=True)
    if s["mv_err"] > SIDE_GATE:
        fail(f"11b: the fold operator disagrees with the general assembler: {s['mv_err']:.3e}")
    if c["K2"] <= 0 or max(c[k] for k in ("K1", "K3", "K4", "K5")) != 0:
        fail(f"11b: K2 must launch and no assembler kernel: {c}")
    launches["K2"]["11b"] = c["K2"]

    c, s = square_path(dev, gen)
    print(f"11c 2-D, demo_periodic_geometrical's problem at n={s['n']} ({s['dofs']} dofs, f64) through "
          f"LinearProblem (element-kernel lean fold), cg + Chebyshev: "
          + _count_gate("11c 2-D cg", s["its"], JAX_CPU_SQUARE_ITS, False)
          + f", first solve with assembly {s['first_s']:.2f} s, then {[round(v, 3) for v in s['solve_s']]} s, "
          f"rnorm {s['rnorm']:.3e}; launches {c['P1']}", flush=True)
    for (k, sv), name in zip(s["solves"].items(), (f"P2 n={s['n_p2']}", f"vector P1 n={s['n']}")):
        print(f"11c 2-D {name} ({sv['dofs']} dofs, f64) through LinearProblem, Jacobi-CG {sv['its']} its to rtol "
              f"1e-8 in {sv['s']:.2f} s with assembly, rnorm {sv['rnorm']:.3e}; launches "
              f"{c['P2' if k == 'K6' else 'vector P1']}", flush=True)
    for k, chk in s["checks"].items():
        print(f"11c {k} on {s['shapes'][k]}: {_check_text(chk)}", flush=True)
    for key, need in (("P1", "K2"), ("P2", "K6"), ("vector P1", "K7")):
        if c[key][need] <= 0 or max(c[key][k] for k in ("K1", "K3", "K4", "K5")) != 0:
            fail(f"11c 2-D {key}: {need} must launch and no assembler kernel: {c[key]}")
        launches[need][f"11c 2-D {key}"] = c[key][need]
    checks = {k: dict(v, shape=s["shapes"][k]) for k, v in s["checks"].items()}

    for n in (N_P2_ELASTICITY, N_P2_ELASTICITY_JAX):
        c, s = p2_elasticity_path(dev, gen, n, check=n == N_P2_ELASTICITY)
        line = (f"11d vector P2 elasticity on fold, n={n} ({s['dofs']} dofs, f64, {s['offsets']} offsets on "
                f"{s['vshape']}): assembly + rhs {s['asm_s']:.2f} s, cg + Chebyshev {s['its']} its at seeds "
                f"{list(FORMAT_SEEDS)} in {[round(v, 3) for v in s['solve_s']]} s, rnorm {s['rnorm']:.3e}")
        if n == N_P2_ELASTICITY:
            line += "; " + _gates("11d", s) + f"; K7 on {s['vshape']} x 3 ({s['data_mb']:.0f} MB): " + _check_text(s["K7"])
            checks["K7 65 offsets"] = dict(s["K7"], shape=s["vshape"] + (3,))
        else:
            line += "; " + _count_gate("11d P2 elasticity cg", s["its"], JAX_CPU_P2_ELASTICITY_ITS, False)
        print(line + f"; launches {c}, K7 by grid {s['by_grid']}", flush=True)
        if c["K7"] <= 0 or c["K2"] != 0:
            fail(f"11d n={n}: K7 must launch and K2 must not: {c}")
        launches["K7"][f"11d n={n}"] = c["K7"]

    for kind, need in (("csr", "K2"), ("cells", "K2"), ("coefficient fold", "K2"), ("2-D", "K2"),
                       ("vector P2", "K7")):
        err, its, c = oracle_lattice_f64(dev, kind)
        print(f"11e f64 oracle {kind} on the card: Jacobi-CG {its} its, max|u - K(K^T A K)^-1 K^T b| {err:.3e} "
              f"(tol 1e-8); launches {c}", flush=True)
        if not err <= 1e-8:
            fail(f"11e f64 oracle {kind}: error {err:.3e} > 1e-8")
        if c[need] <= 0 or max(c[k] for k in ("K1", "K3", "K4", "K5")) != 0:
            fail(f"11e f64 oracle {kind}: {need} must launch and no assembler kernel: {c}")
        launches[need][f"11e {kind}"] = c[need]
    return launches, checks


# ---------------------------------------------------------------------------
# Phase 12: complex scalars
# ---------------------------------------------------------------------------

# 12a: bench.py's P1 mesh at n=64 (274,625 dofs) with a Bloch phase
# u(1, y, z) = e^{i pi/3} u(0, y, z), Dirichlet 0 at y=0/1, the source
# (4 + 2i x0) v, on the "csr" side format (fold refuses the phase), complex64;
# cg to rtol 1e-6 with the Chebyshev preconditioner (one probe seed per
# solve) and with test_gmg's LatticeGMG over "csr" levels (b changed by
# rounding-level noise per seed), then the same in complex128.  The JAX
# package's CPU counts of the Chebyshev solves, from
#   JAX_PLATFORMS=cpu python3 scripts/jax_complex_counts.py --n 64 --dtype complex128 --seeds 0 1 2 --perturb-b=2e-16
#   JAX_PLATFORMS=cpu python3 scripts/jax_complex_counts.py --n 64 --dtype complex64 --seeds 0 1 2 --perturb-b=1.2e-7
# run on the CPU of the card's host: complex128 gated to the JAX range +-2,
# complex64 from above, to the JAX range + 10 % (the JAX package's CPU dot
# products accumulate in sequence: PERF.md, PR 11).  The JAX package's GMG
# preconditions a complex coarse level with the inverse of its real part
# (ROADMAP queue 3), so the GMG counts are gated against the port's own
# complex128 count +-2 instead.
N_COMPLEX = 64
# (JAX 0.9.0 on the CPU of an H100 host: 133 / 133 / 134 / 134 / 134 / 134 its
# in complex128, 173 / 174 / 169 / 173 / 173 / 173 in complex64)
JAX_CPU_BLOCH_CHEB_ITS = {"complex64": (169, 174), "complex128": (133, 134)}
BLOCH = cmath.exp(1j * cmath.pi / 3)
COMPLEX_TOL = {"complex64": 5e-6, "complex128": 1e-12}
C64_GATE = 0.1


def make_bloch(m, dtype, device, side_format="csr"):
    """12a's problem through the port: (V, bc, mpc, a, L, clf)."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, y_planes), V)
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc], scale=BLOCH)
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    L = dmt.LinearForm(V, lambda v, c: (4.0 + 2j * c.x[0]) * v.value)
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format=side_format, device=device)
    return V, bc, mpc, a, L, clf


def _bloch_solves(dev, n, dtype, eps):
    """One dtype of 12a: assembly, Chebyshev-CG per probe seed, the GMG
    hierarchy over "csr" levels and GMG-CG per seed (b changed by eps);
    the solves' times and counts."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.solvers import chebyshev_preconditioner

    t0 = time.time()
    V, bc, mpc, a, L, clf = make_bloch(n, dtype, dev)
    setup_s = time.time() - t0
    torch.cuda.synchronize()
    t0 = time.time()
    A = clf.assemble()
    b = dmt.set_bc(dmt.assemble_vector(L, mpc), [bc])
    torch.cuda.synchronize()
    asm_s = time.time() - t0
    cheb = []
    for seed in FORMAT_SEEDS:
        M = chebyshev_preconditioner(A.matvec, A.diagonal(), probe=np.random.default_rng(seed).standard_normal(
            V.num_dofs))
        torch.cuda.synchronize()
        t0 = time.time()
        x, its, rnorm = dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
        torch.cuda.synchronize()
        cheb.append(dict(its=its, rnorm=rnorm, s=time.time() - t0, x=x))
    t0 = time.time()
    levels, masks = dmt.build_gmg_hierarchy(lambda m: make_bloch(m, dtype, dev)[5], n, 4, min_n=8)
    levels[0] = A
    G = dmt.LatticeGMG(levels, free_masks=masks)
    torch.cuda.synchronize()
    gmg_s = time.time() - t0
    gmg = []
    for seed in FORMAT_SEEDS:
        t0 = time.time()
        x, its, rnorm = dmt.cg(A.matvec, _b_noise(b, seed, eps), M=G, rtol=1e-6, atol=1e-12, max_it=3000)
        torch.cuda.synchronize()
        gmg.append(dict(its=its, rnorm=rnorm, s=time.time() - t0))
    return dict(V=V, A=A, b=b, mpc=mpc, cheb=cheb, gmg=gmg, setup_s=setup_s, asm_s=asm_s, gmg_s=gmg_s,
                levels=[o.dia.vshape for o in levels], coarse=str(G.coarse_inv.dtype)[6:],
                masks=str(masks[0].dtype)[6:], n_side=int(A.side_data.shape[0]))


def bloch_path(dev, n=N_COMPLEX):
    """12a in complex64 and complex128, counters reset before and read
    after; complex64's backward error in complex128 and its forward error
    against a complex128 Jacobi-CG solve of the same operator, and the warm
    ms per iteration of its Chebyshev-CG."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.la.solvers import chebyshev_preconditioner, jacobi_preconditioner

    reset_counts()
    runs = {"complex64": _bloch_solves(dev, n, np.complex64, 1.2e-7),
            "complex128": _bloch_solves(dev, n, np.complex128, 2e-16)}
    counts = read_counts(("K2", "K6", "K7", "K8"))
    by_dtype = dict(wrapper("K2").launches_by_dtype)
    r = runs["complex64"]
    A, b, x = r["A"], r["b"], r["cheb"][0]["x"]
    A128 = plain_operator(A, torch.complex128)
    x_ref, its_ref, _ = dmt.cg(A128.matvec, b.to(torch.complex128), M=jacobi_preconditioner(A128.diagonal()),
                               rtol=1e-12, atol=0.0, max_it=5000)
    eta, rel_res, fwd = error_gates(A, b, x, x_ref, wide=torch.complex128)
    M = chebyshev_preconditioner(A.matvec, A.diagonal(), probe=np.random.default_rng(0).standard_normal(b.shape[0]))
    dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)  # warm
    torch.cuda.synchronize()
    t0 = time.time()
    _, its_w, _ = dmt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)
    torch.cuda.synchronize()
    ms_per_it = 1e3 * (time.time() - t0) / max(its_w, 1)
    slaves = np.asarray(r["mpc"].slaves)
    masters = r["mpc"]._np_masters[:, 0]
    u = r["mpc"].finalized.backsubstitution(x).cpu().numpy()
    phase_err = float(np.abs(u[slaves] - BLOCH * u[masters]).max() / np.abs(u).max())
    summary = dict(n=n, dofs=r["V"].num_dofs, eta=eta, rel_res=rel_res, fwd=fwd, its_ref=its_ref,
                   ms_per_it=ms_per_it, phase_err=phase_err, by_dtype=by_dtype, imag=float(b.imag.abs().max()))
    for dt, rr in runs.items():
        summary[dt] = {k: rr[k] for k in ("setup_s", "asm_s", "gmg_s", "levels", "coarse", "masks", "n_side")}
        summary[dt].update(cheb=[c["its"] for c in rr["cheb"]], gmg=[g["its"] for g in rr["gmg"]],
                           cheb_s=[c["s"] for c in rr["cheb"]], gmg_s_solve=[g["s"] for g in rr["gmg"]],
                           rnorm=rr["cheb"][0]["rnorm"])
    return counts, summary, A


def _complex_randn(gen, shape, dev, dtype):
    import torch

    re = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
    im = torch.randn(shape, generator=gen, device=dev, dtype=torch.float64)
    return torch.complex(re, im).to(dtype)


def _dia_csr(data, offsets, vshape, bs):
    """The DIA operator (n_off, bs, bs, n0, n1, n2) as a torch sparse CSR on
    its device, built there (cuSPARSE's operand for the library time)."""
    import torch

    n0, n1, n2 = vshape
    dev = data.device
    I, J, K = torch.meshgrid(*(torch.arange(m, device=dev) for m in vshape), indexing="ij")
    vid = (I * n1 + J) * n2 + K
    rows, cols, vals = [], [], []
    for d, (di, dj, dk) in enumerate(offsets):
        m = ((I + di >= 0) & (I + di < n0) & (J + dj >= 0) & (J + dj < n1) & (K + dk >= 0) & (K + dk < n2))
        r, c = vid[m], (((I + di) * n1 + (J + dj)) * n2 + (K + dk))[m]
        for ci in range(bs):
            for cj in range(bs):
                rows.append(r * bs + ci)
                cols.append(c * bs + cj)
                vals.append(data[d, ci, cj][m])
    N = n0 * n1 * n2 * bs
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals), (N, N))
    return coo.coalesce().to_sparse_csr()


def _blocked_csr(data, trips, classes, cdims, r3=(2, 2, 2)):
    """The blocked operator on the flat dof vector of its (2s - 1)^3 grid as
    a torch sparse CSR on its device (BlockDIAMatrix.to_scipy's entries)."""
    import torch

    s0, s1, s2 = cdims
    n0, n1, n2 = (r * s - (r - 1) for r, s in zip(r3, cdims))
    dev = data.device
    Q0, Q1, Q2 = torch.meshgrid(*(torch.arange(m, device=dev) for m in cdims), indexing="ij")
    rows, cols, vals = [], [], []
    for m, (cr, cc, off) in enumerate(trips):
        fi, fj, fk = r3[0] * Q0 + cr[0], r3[1] * Q1 + cr[1], r3[2] * Q2 + cr[2]
        gi, gj, gk = (r3[0] * (Q0 + off[0]) + cc[0], r3[1] * (Q1 + off[1]) + cc[1], r3[2] * (Q2 + off[2]) + cc[2])
        ok = ((fi < n0) & (fj < n1) & (fk < n2) & (gi >= 0) & (gi < n0) & (gj >= 0) & (gj < n1) & (gk >= 0)
              & (gk < n2))
        rows.append(((fi * n1 + fj) * n2 + fk)[ok])
        cols.append(((gi * n1 + gj) * n2 + gk)[ok])
        vals.append(data[m][ok])
    N = n0 * n1 * n2
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]), torch.cat(vals), (N, N))
    return coo.coalesce().to_sparse_csr(), (n0, n1, n2)


def dia_kernel_alone_ms(op, x, reps=50):
    """Device time in ms of a DIAMatrix's kernel (K2 / K7) alone: `reps`
    back-to-back calls of its prepared launch's ctypes function into one
    preallocated output between two CUDA events (no allocation, no count;
    the op must have launched once, which prepares the launch)."""
    import torch

    launch = op._launch
    y = torch.empty_like(x)
    dp, pp = launch.args
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return cuda_ms(lambda: launch.fn(dp, x.data_ptr(), y.data_ptr(), pp, stream), reps)


def _complex_check(name, kernel, run, plain, stored, x, index_bytes, lib, alone=None):
    """One complex kernel at one dtype: one counted launch against its
    plain version (fails beyond COMPLEX_TOL), warm and profiler device
    times, the plain version's, the bound and, where `lib` gives one, the
    cuSPARSE CSR product's warm time: lib() gives (S, its x, the map of
    the kernel's output to S's layout).  Where the profiler records no
    kernel and `alone` times the kernel alone (dia_kernel_alone_ms), the
    device time is that one's, and `device_by` says which method gave it."""
    import torch

    dt = str(x.dtype)[6:]
    kid = name.split()[0]
    n0 = wrapper(kid).launches
    got = run()
    torch.cuda.synchronize()
    if wrapper(kid).launches != n0 + 1:
        fail(f"12b {name}: {kid} did not launch once")
    ref = plain()
    rel = _rel_l2(got, ref)
    if not rel <= COMPLEX_TOL[dt]:
        fail(f"12b {name} {dt}: {kid} disagrees with its plain version: {rel:.3e} > {COMPLEX_TOL[dt]:g}")
    bms, by = spmv_bound(stored, x, got, index_bytes)
    lib_ms = None
    if lib is not None:
        S, xl, to_lib = lib()
        lib_ms = cuda_ms(lambda: S @ xl, 50)
        lib_err = _rel_l2(S @ xl, to_lib(got))
        del S
    out = dict(err=rel, max_abs_err=float((got - ref).abs().max()), ms=cuda_ms(run, 50),
               device_ms=profiler_ms(run, 50, kernel), device_by="torch.profiler", plain_ms=cuda_ms(plain, 5),
               bound_ms=bms, bound_by=by, library_ms=lib_ms)
    if alone is not None:
        out["alone_ms"] = alone()
        if out["device_ms"] is None:
            out.update(device_ms=out["alone_ms"], device_by="CUDA events, the kernel alone, back to back")
    dev_txt = ("not measured" if out["device_ms"] is None else f"{out['device_ms']:.4f} ms ({out['device_by']}"
               + (f"; the kernel alone by CUDA events {out['alone_ms']:.4f} ms" if "alone_ms" in out
                  and out["device_by"] == "torch.profiler" else "") + ")")
    lib_txt = ("none" if lib_ms is None else f"{lib_ms:.4f} ms warm (rel L2 to the kernel {lib_err:.1e})")
    print(f"12b {name} {dt}: rel L2 {rel:.3e} (tol {COMPLEX_TOL[dt]:g}), warm {out['ms']:.4f} ms, device {dev_txt}, "
          f"plain {out['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}; {100 * bms / out['ms']:.0f} % of warm), "
          f"cuSPARSE complex CSR {lib_txt}", flush=True)
    return out


def compare_complex_lattice_kernels(dev, gen, A_bloch):
    """12b: K2 on the 12a operator's DIA (65^3), K7 on complex random planes
    with the P1 path's 15 offsets on 65^3 x 3 and K6 on complex random
    planes with the 230 P2 triples on 8 x 65^3, each in complex64 (the
    12a data) and complex128, against its plain version.  Returns
    {kernel: {dtype: numbers}}."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, DIAMatrix

    out = {"K2": {}, "K7": {}, "K6": {}}
    dia = A_bloch.dia
    offs = make_problem(2, np.float64, "cpu")[4].offsets
    trips = make_problem(2, np.float64, "cpu", degree=2)[4].trips
    n = N_MAIN + 1
    for ct in (torch.complex64, torch.complex128):
        dt = str(ct)[6:]
        data = dia.data.to(ct).contiguous()
        op = DIAMatrix(data, dia.offsets, dia.vshape, 1)
        x = _complex_randn(gen, (dia.shape[0],), dev, ct)
        out["K2"][dt] = _complex_check(
            f"K2 dia_matvec {dia.vshape}", "dia_matvec_kernel", lambda: op.matvec(x),
            lambda: LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 1, x), data.numel(), x, 0,
            lambda: (_dia_csr(data, dia.offsets, dia.vshape, 1), x, lambda y: y))
        del op, data
        data = _complex_randn(gen, (len(offs), 3, 3, n, n, n), dev, ct)
        op = DIAMatrix(data, offs, (n, n, n), 3)
        x = _complex_randn(gen, (3 * n ** 3,), dev, ct)
        out["K7"][dt] = _complex_check(
            f"K7 dia_matvec_bs {(n, n, n)} x 3", "dia_matvec_kernel", lambda: op.matvec(x),
            lambda: LK.dia_matvec_plain(data, offs, (n, n, n), 3, x), data.numel(), x, 0,
            lambda: (_dia_csr(data, offs, (n, n, n), 3), x, lambda y: y), alone=lambda: dia_kernel_alone_ms(op, x))
        del op, data
        data = _complex_randn(gen, (len(trips), n, n, n), dev, ct)
        op = BlockDIAMatrix(data, trips, (2 * n - 1,) * 3, (2, 2, 2))
        # x zero on the class grids' padding, as the solve path's is
        xf = _complex_randn(gen, ((2 * n - 1) ** 3,), dev, ct)
        xb = op.to_blocked(xf).contiguous()
        pts = LK.blocked_launch_params(trips, op.classes, (n, n, n), data.element_size()).pts
        out["K6"][dt] = _complex_check(
            f"K6 blocked_matvec 8 x {(n, n, n)} ({len(trips)} triples, {pts} plane points per block)",
            "blocked_matvec_kernel", lambda: op.matvec_blocked(xb),
            lambda: LK.blocked_matvec_plain(data, trips, op.classes, xb), data.numel(), xb, 8 * len(trips),
            lambda: (_blocked_csr(data, trips, op.classes, (n, n, n))[0], xf, op.from_blocked))
        del op, data, xb
    return out


def compare_complex_k8(dev, gen, As):
    """12b: K8 on the packed layout of the NB=24/NT=20 contact operator made
    complex (its values times e^{0.3 i}), complex64 and complex128, against
    its plain version, with the cuSPARSE complex CSR product of the same
    operator."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.la import bell as BL

    out = {}
    Sc = (As * cmath.exp(0.3j)).tocsr()
    Sc.eliminate_zeros()
    for ndt in (np.complex64, np.complex128):
        B = BL.bell_from_scipy(Sc, dtype=ndt, device=dev)
        P = B.packed
        ct = P.vals.dtype
        x = _complex_randn(gen, (B.shape[1],), dev, ct)
        out[str(ct)[6:]] = _complex_check(
            f"K8 bell_matvec (contact NB={NB_CONTACT}/NT={NT_CONTACT} x e^(0.3i), {P.nnz} nonzeros)",
            "bell_csr_matvec_kernel", lambda: B.matvec(x), lambda: BL.bell_packed_matvec_plain(P, x),
            P.nnz, x, P.nnz * 4 + P.row_ptr.numel() * 4,
            lambda: (torch.sparse_csr_tensor(torch.as_tensor(Sc.indptr.astype(np.int32)),
                                             torch.as_tensor(Sc.indices.astype(np.int32)),
                                             torch.as_tensor(Sc.data.astype(ndt)), size=Sc.shape, device=dev),
                     x, lambda y: y))
        del B, P
    return out


def oracle_c128(dev, kind):
    """12c: complex128 on the card against u = K (K^H A K)^-1 K^H b from
    scipy, counters reset before the solve and read after: "dtypes" (the
    lattice problem of tests/test_dtypes.py: unit cube 3^3, periodic,
    Dirichlet 0.3, LinearProblem on the lean fold path, K2), "Bloch
    LinearProblem" and "Bloch csr" (12a's problem at n=6 through
    LinearProblem, which takes "cells", and on "csr" with Jacobi-CG, K2),
    "elasticity" (bs=3 P1 n=4 through LinearProblem, K7), "P2" (degree 2
    n=3 through LinearProblem, K6), "contact" (tied contact NB=4/NT=3 with a
    body force: BELL + AMG + CG, K8).  Returns (max error, its, launches
    with K2/K6/K7/K8's by dtype)."""
    import numpy as np
    import scipy.sparse.linalg as spla

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    c128 = np.complex128
    opts = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12}
    if kind == "contact":
        V, bcs, mpc, a, L = make_contact(4, 3, c128, dev, body_force=True)
    elif kind.startswith("Bloch"):
        V, bc, mpc, a, L, clf = make_bloch(6, c128, dev)
        bcs = [bc]
    else:
        m, degree, bs = {"dtypes": (3, 1, None), "elasticity": (4, 1, 3), "P2": (3, 2, None)}[kind]
        V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", degree, (bs,)) if bs else ("Lagrange", degree))
        bcs = [dmt.dirichletbc(np.zeros(bs) if bs else (0.3 if kind == "dtypes" else 0.0),
                               dmt.locate_dofs_geometrical(V, y_planes), V)]
        mpc = dmt.MultiPointConstraint(V, c128, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), bcs)
        mpc.finalize()
        if kind == "elasticity":
            a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v)))
                                 + 1.25 * div(u) * conj(div(v)), quad_degree=1)
            L = dmt.LinearForm(V, lambda v, c: (1.0 + 1j * c.x[0] * c.x[2]) * v.value[..., 0] - v.value[..., 2])
        else:
            # P2 at quad_degree 2, where the lattice path takes it (soa_supported)
            a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)) + inner(u, v),
                                 quad_degree=2 if kind == "P2" else None)
            L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] + 0.5j * c.x[1]) * v.value)
    reset_counts()
    if kind in ("Bloch csr", "contact"):
        if kind == "contact":
            A = dmt.assemble_matrix(a, mpc, bcs)
            As = A.to_scipy()
            op = bell_from_scipy(As, dtype=c128, device=dev)
            M = smoothed_aggregation_amg(As, bs=3, dtype=c128, nullspace=rigid_motions_nullspace(V), coarse_size=100,
                                         device=dev)
        else:
            op = clf.assemble()
            M = jacobi_preconditioner(op.diagonal())
        b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
        x, its, _ = dmt.cg(op.matvec, b, M=M, rtol=1e-12, atol=0.0, max_it=5000)
        u = mpc.finalized.backsubstitution(x)
    else:
        prob = dmt.LinearProblem(a, L, mpc, bcs=bcs, petsc_options=opts)
        u, its = prob.solve().x.array, prob.its
        if (kind == "Bloch LinearProblem") != (getattr(prob.A, "side_Aep", None) is not None):
            fail(f"12c {kind}: LinearProblem took the wrong lattice route")
    counts = read_counts(KERNELS)
    counts.update({f"{k} by dtype": dict(wrapper(k).launches_by_dtype) for k in ("K2", "K6", "K7", "K8")})
    A0 = dmt.assemble_matrix(a, None, bcs, dtype=c128, device="cpu").to_scipy()
    b0 = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, None, dtype=c128, device="cpu"), [a], [bcs],
                                      dtype=c128, device="cpu"), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.conj().T @ A0 @ K).tocsc(), K.conj().T @ b0)
    return float(np.abs(u.cpu().numpy() - u_ref).max()), its, counts


def _gmg_gate(its, ref):
    """12a's GMG gate: the complex64 mean within the port's own complex128
    range +-2 (the JAX package's GMG drops the imaginary part of its
    coarse level, ROADMAP queue 3)."""
    import numpy as np

    mean = float(np.mean(its))
    lo, hi = ref[0] - 2, ref[1] + 2
    if not lo <= mean <= hi:
        fail(f"12a GMG-CG c64: mean {mean:.1f} its outside [{lo}, {hi}] (the port's c128 counts {ref})")
    return (f"{its} its at seeds {list(FORMAT_SEEDS)} (mean {mean:.1f}; the port's c128 range {ref}, gate "
            f"[{lo}, {hi}])")


def slice12_phases(dev, gen, k8c):
    """Phase 12 with its gates and report lines (k8c: 12b's K8 numbers,
    measured beside the contact path).  Returns the complex launches of
    K2, K6, K7 and K8 by sub-phase and the 12b numbers, for the kernels
    line."""
    import io

    import numpy as np

    from dolfinx_mpc_tpu_torch.utils import timing

    timing.reset_timings()
    launches = {"K2": {}, "K6": {}, "K7": {}, "K8": {}}
    c, s, A = bloch_path(dev)
    s64, s128 = s["complex64"], s["complex128"]
    gmg128 = (min(s128["gmg"]), max(s128["gmg"]))
    print(f"12a Bloch phase e^(i pi/3), P1 n={s['n']} ({s['dofs']} dofs, csr side {s64['n_side']} entries, complex "
          f"source: max|Im b| {s['imag']:.3e}): complex64 set-up {s64['setup_s']:.2f} s, assembly + rhs "
          f"{s64['asm_s']:.2f} s, cg + Chebyshev "
          + _count_gate("12a Chebyshev-CG c64", s64["cheb"], JAX_CPU_BLOCH_CHEB_ITS["complex64"], True,
                        from_above=True)
          + f" in {[round(v, 3) for v in s64['cheb_s']]} s, {s['ms_per_it']:.4f} ms/it warm, rnorm {s64['rnorm']:.3e}; "
          + _gates("12a", s).replace("in f64", "in c128").replace("x64", "x128")
          + f", max|u_s - e^(i pi/3) u_m| / max|u| {s['phase_err']:.1e}; GMG over csr levels {s64['levels']} "
          f"(coarse inverse {s64['coarse']}, masks {s64['masks']}) built in {s64['gmg_s']:.2f} s, cg "
          + _gmg_gate(s64["gmg"], gmg128)
          + f" in {[round(v, 3) for v in s64['gmg_s_solve']]} s; complex128: assembly {s128['asm_s']:.2f} s, cg + "
          f"Chebyshev " + _count_gate("12a Chebyshev-CG c128", s128["cheb"], JAX_CPU_BLOCH_CHEB_ITS["complex128"],
                                      False)
          + f", GMG-CG {s128['gmg']} its (coarse inverse {s128['coarse']}); launches {c}, K2 by dtype "
          f"{s['by_dtype']} (the real ones: the levels' Gershgorin bounds)", flush=True)
    # the real launches are the GMG levels' Gershgorin bounds, |A| . 1 in the
    # real dtype (the JAX package's, la/gmg.py:70, 78)
    if min(s["by_dtype"].get(k, 0) for k in ("complex64", "complex128")) <= 0:
        fail(f"12a: K2 must launch in complex64 and complex128: {c}, {s['by_dtype']}")
    if not s["phase_err"] <= 1e-5:
        fail(f"12a: the solution does not carry the Bloch phase: {s['phase_err']:.3e}")
    launches["K2"]["12a"] = s["by_dtype"]["complex64"] + s["by_dtype"]["complex128"]
    checks = compare_complex_lattice_kernels(dev, gen, A)
    del A
    checks["K8"] = k8c
    for kind, need in (("dtypes", "K2"), ("Bloch LinearProblem", "K2"), ("Bloch csr", "K2"), ("elasticity", "K7"),
                       ("P2", "K6"), ("contact", "K8")):
        err, its, cc = oracle_c128(dev, kind)
        print(f"12c complex128 oracle {kind} on the card: CG {its} its, max|u - K(K^H A K)^-1 K^H b| {err:.3e} "
              f"(tol 1e-8); launches {cc}", flush=True)
        if not err <= 1e-8:
            fail(f"12c complex128 oracle {kind}: error {err:.3e} > 1e-8")
        if cc[need] <= 0 or cc[f"{need} by dtype"].get("complex128", 0) != cc[need] or max(
                cc[k] for k in ("K1", "K3", "K4", "K5")) != 0:
            fail(f"12c complex128 oracle {kind}: {need} must launch in complex128 and no assembler kernel: {cc}")
        launches[need][f"12c {kind}"] = cc[need]
    buf = io.StringIO()
    timing.list_timings(file=buf)
    names = ("~MPC: Assemble matrix", "~MPC: Assemble vector", "~MPC: Finalize MPC", "~MPC: Solve linear problem",
             "~MPC: Backsubstitution")
    print("12d list_timings() over phase 12 (host spans; the card ran each span's work asynchronously):\n"
          + buf.getvalue().rstrip(), flush=True)
    got = timing.timings()
    if any(got.get(k, (0,))[0] <= 0 for k in names):
        fail(f"12d: a span was not opened: {sorted(got)}")
    return launches, checks


# ---------------------------------------------------------------------------
# phase 13: the distributed paths on ranks sharing the card (gloo) and on
# NCCL ranks, each rank one spawned process (parallel/launch.py:run_ranks)
# ---------------------------------------------------------------------------

# the CG counts of the JAX package's dry run on 8 devices (MULTICHIP_r05.json)
MULTICHIP_R05_ITS = {"lattice-halo": 70, "lattice-2d": 70, "lattice-gmg": 15, "lattice-gmg-3level": 16,
                     "general": 70, "contact": 67}
N_SPMD = 64  # bench.py's P1 problem: 274,625 dofs
N_SPMD_MILLION = 102  # tests/test_lattice_spmd.py's million-dof case: 1,092,727 dofs
N_SPMD_VECTOR = 16
SPMD_GATE = 1e-7
SPMD_KERNEL_GATE = 1e-12  # f64 kernel against its plain version, relative to max|y|


def spmd_problem(n, dev, bc_value=0.0, vector=False):
    """The sharded paths' problem on the unit cube: P1 tets, periodic in x,
    Dirichlet bc_value on y = 0 and 1, quad_degree 1; Poisson with source
    4 (bench.py's P1 problem at bc_value 0, tests/test_lattice_spmd.py's at
    0.5) or, vector, bs=3 elasticity (mu 1, lambda 1.25) under a constant
    body force.  Returns (V, a, L, mpc, bcs), float64 on `dev`."""
    import numpy as np

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1, (3,)) if vector else ("Lagrange", 1))
    g = np.zeros(3) if vector else bc_value
    bc = dmt.dirichletbc(g, dmt.locate_dofs_geometrical(V, y_planes), V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    if vector:
        a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)),
                             quad_degree=1)
        L = dmt.LinearForm(V, lambda v, c: v.value[..., 0] + 0.5 * v.value[..., 2])
    else:
        a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
        L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    return V, a, L, mpc, [bc]


def _spmd_case(info, case, n):
    """One sharded solve on this rank: "gmg" (P1 n=64, two-level GMG over
    a replicated (32, 16, 8) LatticeGMG built on the card, rtol 1e-10),
    "general" (P1 n=64 through ShardedLinearProblem, Jacobi, rtol 1e-10),
    "vector" (bs=3 n=16, Jacobi, rtol 1e-10) or "million" (n=102,
    Chebyshev degree 4, rtol 1e-11).  Returns the numbers of the case (the
    solution from rank 0 only)."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.la.gmg import LatticeGMG, build_gmg_hierarchy
    from dolfinx_mpc_tpu_torch.ops.lattice import assemble_matrix_lattice
    from dolfinx_mpc_tpu_torch.parallel import ShardedLatticeProblem, ShardedLinearProblem, make_device_mesh
    from dolfinx_mpc_tpu_torch.parallel.dryrun import launch_counts

    dev = info.device
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    before = launch_counts()
    t0 = time.perf_counter()
    V, a, L, mpc, bcs = spmd_problem(n, dev, 0.5 if case == "million" else 0.0, vector=case == "vector")
    mesh = make_device_mesh(device=dev)
    if case == "general":
        prob = ShardedLinearProblem(a, L, mpc, bcs, device_mesh=mesh, rtol=1e-10, max_it=5000)
    elif case == "gmg":
        def level(m):
            _, al, _, mpcl, bcl = spmd_problem(m, dev)
            return assemble_matrix_lattice(al, mpcl, bcs=bcl, side_format="fold", device=dev)

        ops, masks = build_gmg_hierarchy(level, n // 2, 3, min_n=4)
        prob = ShardedLatticeProblem(a, L, mpc, bcs, device_mesh=mesh, rtol=1e-10, pc_type="gmg",
                                     coarse_gmg=LatticeGMG(ops, free_masks=masks))
    elif case == "million":
        prob = ShardedLatticeProblem(a, L, mpc, bcs, device_mesh=mesh, rtol=1e-11, pc_type="chebyshev",
                                     cheb_degree=4)
    else:
        prob = ShardedLatticeProblem(a, L, mpc, bcs, device_mesh=mesh, rtol=1e-10, max_it=5000)
    t_build = time.perf_counter() - t0
    u, its, rnorm = prob.solve()
    if on_card:
        torch.cuda.synchronize()
    after = launch_counts()
    out = dict(case=case, rank=info.rank, dofs=V.num_dofs, its=its, rnorm=rnorm, build_s=t_build, **prob.times,
               peak_mb=torch.cuda.max_memory_allocated() / 2 ** 20 if on_card else 0.0, backend=info.backend,
               launches={k: after[k] - before[k] for k in after}, finite=bool(torch.isfinite(u).all()))
    if case == "general":
        out["window"] = prob._window
    else:
        out["memory"] = prob.memory_report()
    if info.rank == 0:
        out["u"] = u.cpu().numpy()
    out["vs_plain"] = _rank_kernel_check(prob, case, dev, info.rank)  # after the counts: not counted
    return out


def _rank_kernel_check(prob, case, dev, rank):
    """The case's SpMV kernel on this rank's own operator, at the shape the
    solve gave it, against its plain version on one seeded vector: K2 (bs =
    1) or K7 (bs = 3) on the rank's halo-extended DIAMatrix, K8 on the
    rank's ghost-window row block (a BellPacked CSR).  Returns the kernel,
    the shape and max|y - y_plain| / max|y_plain|."""
    import torch

    from dolfinx_mpc_tpu_torch.la.bell import bell_matvec, bell_packed_matvec_plain
    from dolfinx_mpc_tpu_torch.ops.lattice_kernels import dia_matvec_plain

    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + rank)
    if case == "general":
        A = prob._assemble()[0]
        x = torch.rand(A.shape[1], generator=gen, dtype=A.vals.dtype, device=dev)
        y, ref = bell_matvec(A, x), bell_packed_matvec_plain(A, x)
        kid, shape = "K8", f"{A.shape[0]} x {A.shape[1]}, {A.nnz} nonzeros"
    else:
        dia = prob._assemble()[0]
        x = torch.rand(dia.shape[0], generator=gen, dtype=dia.data.dtype, device=dev)
        y = dia.matvec(x)
        ref = dia_matvec_plain(dia.data.reshape(len(dia.offsets), dia.bs, dia.bs, *dia.vshape), dia.offsets,
                               dia.vshape, dia.bs, x)
        kid, shape = ("K2" if dia.bs == 1 else "K7"), "x".join(map(str, dia.vshape)) + f" x {dia.bs}"
    rel = float((y - ref).abs().max() / ref.abs().max())
    return dict(kernel=kid, shape=shape, rel=rel)


def _spmd_rank(info, cases):
    return [_spmd_case(info, c, n) for c, n in cases]


def single_device_solution(n, dev, bc_value=0.0, vector=False):
    """The port's single-device solve of spmd_problem on the card, float64,
    rtol 1e-12: LinearProblem (fold operator, Jacobi-CG) below n=100, the
    fold operator with GMG-CG (levels n, n/2, Chebyshev smoother) above."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt

    V, a, L, mpc, bcs = spmd_problem(n, dev, bc_value, vector)
    t0 = time.time()
    if n < 100:
        prob = dmt.LinearProblem(a, L, mpc, bcs=bcs, petsc_options={"ksp_rtol": 1e-12, "ksp_atol": 0.0,
                                                                    "ksp_max_it": 20000})
        u = prob.solve().x.array
        its = prob.its
    else:
        A = dmt.assemble_matrix_lattice(a, mpc, bcs=bcs, side_format="fold", device=dev).assemble()
        b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)

        def level(m):
            _, al, _, mpcl, bcl = spmd_problem(m, dev, bc_value)
            return dmt.assemble_matrix_lattice(al, mpcl, bcs=bcl, side_format="fold", device=dev)

        ops, masks = dmt.build_gmg_hierarchy(level, n, 2, min_n=8)
        ops[0] = A
        M = dmt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev")
        x, its, _ = dmt.cg(A.matvec, b, M=M, rtol=1e-12, atol=0.0, max_it=3000)
        u = mpc.finalized.backsubstitution(x)
    torch.cuda.synchronize()
    return u.cpu().numpy(), int(its), time.time() - t0


def _rank_line(r):
    t = r["its"] or 1
    mem = r.get("memory")
    mtxt = (f", memory_report sharded {mem['sharded_per_device'] / 2 ** 20:.2f} MB (stencil "
            f"{mem['stencil_data_per_device'] / 2 ** 20:.2f}, CG vectors {mem['solver_vectors_per_device'] / 2 ** 20:.2f})"
            f" + replicated coarse {mem['replicated_coarse'] / 2 ** 20:.2f} MB" if mem else
            f", ghost window {r.get('window')} of {r['dofs']}")
    return (f"rank {r['rank']}: {1e3 * r['solve_s'] / t:.3f} ms/it, exchange host {1e3 * r['comm_s'] / t:.3f} ms/it "
            f"({r['comm_calls'] / t:.1f} collectives/it), set-up {r['build_s']:.2f} + {r['setup_s']:.2f} s, peak device "
            f"{r['peak_mb']:.1f} MB{mtxt}, launches {r['launches']}")


def slice13_phases(dev, gen):
    """Phase 13: 13a dryrun_multichip(8) on gloo ranks sharing the card,
    against MULTICHIP_r05.json's counts (+-2) and with the dry run's own
    solution gates, then on one NCCL rank (and on NCCL over every card
    where there are two or more); 13b bench.py's P1 problem at n=64
    through ShardedLatticeProblem with the two-level GMG on 4 gloo ranks
    sharing the card and on 1 NCCL rank, and a bs=3 elasticity problem at
    n=16 (K7); 13c the million-dof case (n=102, Chebyshev 4) on the 4
    ranks; 13d the general path (ShardedLinearProblem) at n=64 on the 4
    ranks; each against the single-device solve within 1e-7; 13e the SoA
    element kernel against the cell-first kernel on 1,572,864 cells.
    Each rank of 13b-13d also holds its SpMV kernel against the plain
    version on its own operator.  Returns the phase's launches per rank,
    those checks per rank and 13e's numbers."""
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.parallel import run_ranks
    from dolfinx_mpc_tpu_torch.parallel.dryrun import dryrun_multichip

    t_phase = time.time()
    reserved0 = torch.cuda.memory_reserved()
    launches, vs_plain = {}, {}

    def count_gate(name, outs):
        for key, ref in MULTICHIP_R05_ITS.items():
            if key in outs and abs(outs[key]["its"] - ref) > 2:
                fail(f"{name}: {key} took {outs[key]['its']} CG its, MULTICHIP_r05.json {ref} (+-2 allowed)")

    t0 = time.time()
    print(f"13a dryrun_multichip(8, backend='gloo', device='cuda'): 8 ranks sharing {torch.cuda.get_device_name(0)}",
          flush=True)
    outs = dryrun_multichip(8, backend="gloo", device="cuda")
    count_gate("13a gloo x 8", outs[0])
    per_rank = [o["launches"] for o in outs]
    print(f"13a transport gloo, 8 ranks: {time.time() - t0:.1f} s, counts "
          f"{ {k: outs[0][k]['its'] for k in MULTICHIP_R05_ITS} } (MULTICHIP_r05.json {MULTICHIP_R05_ITS}); launches "
          f"per rank {per_rank}", flush=True)
    if min(c["K2"] for c in per_rank) <= 0 or min(c["K8"] for c in per_rank) <= 0:
        fail(f"13a: every rank must launch K2 (slab matvecs, coarse levels) and K8 (row blocks): {per_rank}")
    launches["13a gloo x 8"] = per_rank

    t0 = time.time()
    print("13a dryrun_multichip(1, backend='nccl', device='cuda'): 1 rank", flush=True)
    nccl_dry = dryrun_multichip(1, backend="nccl", device="cuda")[0]
    count_gate("13a nccl x 1", nccl_dry)
    print(f"13a transport nccl, 1 rank: {time.time() - t0:.1f} s; launches {nccl_dry['launches']}", flush=True)
    launches["13a nccl x 1"] = [nccl_dry["launches"]]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        print(f"13a dryrun_multichip({n_cards}, backend='nccl', device='cuda'): one rank per card", flush=True)
        outs_n = dryrun_multichip(n_cards, backend="nccl", device="cuda")
        count_gate(f"13a nccl x {n_cards}", outs_n[0])
        launches[f"13a nccl x {n_cards}"] = [o["launches"] for o in outs_n]
    else:
        print(f"13a NCCL over several cards: not run ({n_cards} card)", flush=True)

    t0 = time.time()
    cases = (("gmg", N_SPMD), ("vector", N_SPMD_VECTOR), ("general", N_SPMD), ("million", N_SPMD_MILLION))
    outs4 = run_ranks(_spmd_rank, 4, backend="gloo", device="cuda", args=(cases,))
    t_ranks = time.time() - t0
    t0 = time.time()
    u64, its64, t64 = single_device_solution(N_SPMD, dev)
    uvec, itsvec, tvec = single_device_solution(N_SPMD_VECTOR, dev, vector=True)
    u102, its102, t102 = single_device_solution(N_SPMD_MILLION, dev, 0.5)
    print(f"13b-d single-device references on the card (f64, rtol 1e-12): n={N_SPMD} {its64} its in {t64:.2f} s, "
          f"bs=3 n={N_SPMD_VECTOR} {itsvec} its in {tvec:.2f} s, n={N_SPMD_MILLION} GMG-CG {its102} its in {t102:.2f} s; "
          f"the 4 ranks' run {t_ranks:.1f} s", flush=True)
    ref = {"gmg": u64, "general": u64, "vector": uvec, "million": u102}
    label = {"gmg": f"13b P1 n={N_SPMD} two-level GMG", "vector": f"13b bs=3 n={N_SPMD_VECTOR} Jacobi",
             "general": f"13d general path P1 n={N_SPMD} Jacobi", "million": f"13c P1 n={N_SPMD_MILLION} Chebyshev 4"}
    need = {"gmg": ("K1", "K2"), "vector": ("K7",), "general": ("K8",), "million": ("K2",)}
    for i, (case, _) in enumerate(cases):
        rs = [o[i] for o in outs4]
        err = float(np.abs(rs[0]["u"] - ref[case]).max())
        print(f"{label[case]} on 4 gloo ranks sharing the card ({rs[0]['dofs']} dofs): CG {[r['its'] for r in rs]} its, "
              f"rnorm {rs[0]['rnorm']:.3e}, max|u - u_single| {err:.3e} (gate {SPMD_GATE:g})", flush=True)
        for r in rs:
            print("    " + _rank_line(r), flush=True)
        if not err <= SPMD_GATE or not all(r["finite"] for r in rs):
            fail(f"{label[case]}: the 4-rank solution differs from the single-device one by {err:.3e}")
        if min(min(r["launches"][k] for k in need[case]) for r in rs) <= 0:
            fail(f"{label[case]}: every rank must launch {need[case]}: {[r['launches'] for r in rs]}")
        launches[label[case]] = [r["launches"] for r in rs]
        vs_plain[label[case]] = [r["vs_plain"] for r in rs]
    t0 = time.time()
    r1 = run_ranks(_spmd_rank, 1, backend="nccl", device="cuda", args=((("gmg", N_SPMD),),))[0][0]
    print(f"13b on 1 NCCL rank: {time.time() - t0:.1f} s", flush=True)
    vs_plain[label["gmg"] + " (nccl x 1)"] = [r1["vs_plain"]]
    err = float(np.abs(r1["u"] - u64).max())
    print(f"{label['gmg']} on 1 NCCL rank: CG {r1['its']} its, rnorm {r1['rnorm']:.3e}, max|u - u_single| {err:.3e} "
          f"(gate {SPMD_GATE:g})\n    " + _rank_line(r1), flush=True)
    if not err <= SPMD_GATE:
        fail(f"13b on 1 NCCL rank: the solution differs from the single-device one by {err:.3e}")
    if abs(outs4[0][0]["its"] - r1["its"]) > 2:
        fail(f"13b: 4 ranks took {outs4[0][0]['its']} CG its, 1 rank {r1['its']} (+-2 allowed)")
    launches[label["gmg"] + " (nccl x 1)"] = [r1["launches"]]

    soa = soa_vs_cell_first(dev)
    print(f"13e SoA element kernel on {soa['cells']} cells (coefficient form, P1 n={N_FORMATS}, f64): "
          f"{soa['soa_ms']:.3f} ms against the cell-first kernel's {soa['cell_first_ms']:.3f} ms, max|diff| / "
          f"max|Ae| {soa['rel']:.2e} (gate 1e-12)", flush=True)
    if not soa["rel"] <= 1e-12:
        fail(f"13e: the SoA element kernel differs from the cell-first one by {soa['rel']:.3e}")
    for name, checks in vs_plain.items():
        print(f"{name}: {checks[0]['kernel']} on each rank's operator against its plain version (gate "
              f"{SPMD_KERNEL_GATE:g}): " + "; ".join(f"rank {i} {c['shape']} {c['rel']:.2e}"
                                                     for i, c in enumerate(checks)), flush=True)
        bad = [c for c in checks if not c["rel"] <= SPMD_KERNEL_GATE]
        if bad:
            fail(f"{name}: a kernel differs from its plain version on a rank's operator: {bad}")
    print(f"phase 13: {time.time() - t_phase:.1f} s (this process's device memory at its start: "
          f"{reserved0 / 2 ** 20:.1f} MB reserved)", flush=True)
    return launches, vs_plain, soa


# ---- phase 16: the single-device forward step of entry.py (the JAX
# package's __graft_entry__.entry()): the periodic Poisson problem at n=8
# (81 dofs), K^H A K assembled from the compiled tables, 50 CG iterations
# with no early exit, backsubstitution; float64, plain torch (no kernel of
# csrc/ runs in it, as no Pallas kernel runs in the JAX step).
ENTRY_CPU_GATE = 1e-12  # the same step on the CPU, same b
ENTRY_DIRECT_GATE = 1e-10  # the direct solve of the assembled system, then u = K x
ENTRY_REPS = 20


def profiler_launches(fn, reps):
    """(device activities per call, cudaLaunchKernel calls per call) of fn()
    from torch.profiler over `reps` warm calls: the first counts the
    kernels, fills and copies the card ran (None where the profiler records
    none), the second the host's launch calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    on_card = sum(e.count for e in ev if e.device_type.name == "CUDA")
    host = sum(e.count for e in ev if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    return (on_card / reps if on_card else None), host / reps


def entry_phase(dev):
    """16: entry()'s step on the card against the same step on the CPU and
    against scipy's direct solve of the assembled K^H A K followed by
    backsubstitution, with the step's CUDA-event time and its launches per
    step; fails beyond either gate or where a kernel of csrc/ launched."""
    import scipy.sparse.linalg as spla
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.parallel.dryrun import build_problem

    t0 = time.time()
    step, (b,) = dmt.entry(device=dev)
    setup_s = time.time() - t0
    reset_counts()
    u = step(b)
    torch.cuda.synchronize()
    counts = read_counts(KERNELS)
    if u.device.type != "cuda" or u.dtype != torch.float64 or not bool(torch.isfinite(u).all()):
        fail(f"16: the step did not return finite float64 values on the card: {u.device}, {u.dtype}")
    step_cpu, _ = dmt.entry(device="cpu")
    vs_cpu = _rel_l2(u.cpu(), step_cpu(b.cpu()))
    V, a, _, mpc, bc = build_problem(8, device="cpu")
    A = dmt.assemble_matrix(a, mpc, bcs=[bc], diagval=1.0).to_scipy().tocsc()
    u_direct = mpc.finalized.backsubstitution(torch.as_tensor(spla.spsolve(A, b.cpu().numpy())))
    vs_direct = _rel_l2(u.cpu(), u_direct)
    ms = cuda_ms(lambda: step(b), ENTRY_REPS)
    on_card, host_launches = profiler_launches(lambda: step(b), ENTRY_REPS)
    on_card_txt = "not measured (the profiler recorded none)" if on_card is None else f"{on_card:.1f}"
    print(f"16 entry() step, periodic Poisson n=8 ({V.num_dofs} dofs, f64, 50 CG its): set-up {setup_s:.2f} s; "
          f"rel L2 to the same step on the CPU {vs_cpu:.3e} (gate {ENTRY_CPU_GATE:g}), to the direct solve + "
          f"backsubstitution {vs_direct:.3e} (gate {ENTRY_DIRECT_GATE:g}); {ms:.4f} ms per step (CUDA events, "
          f"{ENTRY_REPS} back to back); per step {host_launches:.1f} cudaLaunchKernel calls, {on_card_txt} "
          f"device activities (torch.profiler); kernels of csrc/ launched {counts}", flush=True)
    if not vs_cpu <= ENTRY_CPU_GATE:
        fail(f"16: the step on the card differs from the CPU's by {vs_cpu:.3e}")
    if not vs_direct <= ENTRY_DIRECT_GATE:
        fail(f"16: the step differs from the direct solve by {vs_direct:.3e}")
    if max(counts.values()) != 0:
        fail(f"16: the step is plain torch, yet a kernel of csrc/ launched: {counts}")
    return dict(ms=ms, vs_cpu=vs_cpu, vs_direct=vs_direct, host_launches=host_launches, on_card=on_card)


def soa_vs_cell_first(dev, n=N_FORMATS):
    """13e: the element tensors of the coefficient form (kappa = 1 + x0 x1)
    on every cell of the P1 n mesh in float64, by the SoA kernel and by the
    cell-first kernel, with their CUDA-event times."""
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu_torch.ops.assemble import _coeff_vectors

    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, y_planes), V)
    kappa = dmt.Function(V, device=dev)
    kappa.interpolate(lambda x: 1.0 + x[0] * x[1])
    a = dmt.BilinearForm(V, lambda u, v, c: c["kappa"].value * inner(grad(u), grad(v)), coefficients={"kappa": kappa})
    mpc = dmt.MultiPointConstraint(V, np.float64, device=dev)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=np.float64, side_format="fold", device=dev)
    wl = {k: _coeff_vectors(clf.term, dev)[k][dm] for k, dm in clf._wdofmaps.items()}
    A_soa = clf._element_tensors(clf._coords, wl)
    A_cf = clf._cell_first_tensors(clf._coords, wl)
    rel = float((A_soa - A_cf).abs().max() / A_cf.abs().max())
    del A_soa, A_cf
    torch.cuda.synchronize()
    return dict(cells=V.mesh.num_cells, rel=rel, soa_ms=cuda_ms(lambda: clf._element_tensors(clf._coords, wl), 5, 1),
                cell_first_ms=cuda_ms(lambda: clf._cell_first_tensors(clf._coords, wl), 3, 1))


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
    # phase 13 first: its ranks share the card with this process, which
    # holds next to nothing yet (the 4 ranks of 13c need ~13 GB each)
    launches13, vs_plain13, _ = slice13_phases(dev, gen)
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
    print(rate_text(f"P1 n={s['n']}", s["dofs"], *s["asm_rate"]), flush=True)
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
        if n == N_P2:
            print(rate_text(f"P2 n={n}", s2["dofs"], *s2["asm_rate"]), flush=True)
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
        if n == N_BS3:
            print(rate_text(f"bs=3 n={n}", s4["dofs"], *s4["asm_rate"]), flush=True)
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
    k8c = compare_complex_k8(dev, gen, As)  # phase 12b's K8, on this operator
    del B, As

    counts9, s9, B9, As9 = contact_path(dev, slip=True)
    lattice9 = {k: v for k, v in counts9.items() if k != "K8"}
    print(f"slip contact path NB={s9['nb']}/NT={s9['nt']}, rotated ({s9['dofs']} dofs, {s9['slaves']} slaves, "
          f"{s9['nnz']} nonzeros; BELL tiles {s9['tiles']} + {s9['rem']} remainder entries; AMG levels {s9['levels']} "
          f"as {s9['level_formats']}): host set-up {s9['setup_s']:.2f} s, normal projection {s9['normal_s']:.2f} s "
          f"(|n_project - n_average| {s9['normal_gap']:.3e} on the slave blocks, gate {NORMAL_GATE:g}), constraint "
          f"{s9['constraint_s']:.2f} s, assembly + rhs {s9['asm_s']:.2f} s first (tables included), "
          f"{s9['asm_rhs_ms']:.4f} ms warm (rhs alone: exterior-facet traction + lifting + set_bc "
          f"{s9['rhs_ms']:.4f} ms), BELL conversion {s9['bell_s']:.2f} s, AMG set-up {s9['amg_s']:.2f} s, peak "
          f"device memory of build + solve {s9['peak_mb']:.1f} MB, BELL matvec (one K8 launch) {s9['spmv_ms']:.4f} ms, "
          f"V-cycle {s9['vcycle_ms']:.4f} ms, CG {s9['its']} its in {s9['cg_s']:.4f} s first solve, "
          f"{s9['ms_per_it']:.4f} ms/it warm ({s9['k8_per_it']:.1f} K8 launches/it), rnorm {s9['rnorm']:.3e} "
          f"(|b| {s9['bnorm']:.3e}); recomputed in f64: |b-Ax|/|b| {s9['rel_res']:.3e}, backward error "
          f"{s9['eta']:.3e} (gate {BACKWARD_ERROR_GATE:g}), |x-x64|/|x64| {s9['fwd']:.3e} (gate "
          f"{CONTACT_FORWARD_ERROR_GATE:g}, f64 Jacobi-CG {s9['its_ref']} its); launches {counts9}", flush=True)
    if counts9["K8"] != s9["its"] + 1 or max(lattice9.values()) != 0:
        fail(f"slip contact path: K8 must launch its + 1 = {s9['its'] + 1} times (one per matvec) and no lattice "
             f"kernel: {counts9}")
    if not s9["normal_gap"] <= NORMAL_GATE:
        fail(f"slip contact path: the projected and averaged normals differ by {s9['normal_gap']:.3e}")
    if not s9["eta"] <= BACKWARD_ERROR_GATE:
        fail(f"slip contact path backward error {s9['eta']:.3e} > {BACKWARD_ERROR_GATE:g}")
    if not s9["fwd"] <= CONTACT_FORWARD_ERROR_GATE:
        fail(f"slip contact path solution differs from the f64 solve by {s9['fwd']:.3e}")
    if abs(s9["its"] - JAX_CPU_SLIP_CONTACT_CG_ITS) > 2:
        fail(f"slip contact CG took {s9['its']} its, JAX-CPU takes {JAX_CPU_SLIP_CONTACT_CG_ITS} (+-2 allowed)")
    k8_slip = compare_bell_kernel(dev, gen, B9, As9, label=" (slip contact)", sweep=False)["K8"]
    del B9, As9

    oracle_counts = {}
    for name, n, degree, marker, kind, need, forbid in (
            ("P1 n=6", 6, 1, y_planes, "poisson", ("K1", "K2"), ()),
            ("P2 n=3", 3, 2, y_planes, "poisson", ("K4", "K6"), ()),
            ("P1 n=6, blob set", 6, 1, blob, "poisson", ("K3", "K2"), ()),
            ("bs=3 P1 n=4", 4, 1, y_planes, "elasticity", ("K1", "K7"), ("K2",)),
            ("Dirichlet-free P1 n=6", 6, 1, None, "free", ("K5", "K2"), ("K1", "K4")),
            ("Dirichlet-free P2 n=3", 3, 2, None, "free", ("K5", "K6"), ("K1", "K4")),
            ("slip elasticity 2-D", 0, 1, None, "slip", (), ()),
            ("rotated slip contact NB=3/NT=2 with traction", 0, 1, None, "slip contact", (), ()),
            ("2-D point-to-point tie", 0, 1, None, "p2p", (), ()),
            ("P2 stiffness + Robin ds, general constraint", 0, 2, None, "robin", (), ())):
        err, its64, c = oracle_f64(dev, n, degree, marker, kind)
        print(f"f64 oracle {name} on the card: Jacobi-CG {its64} its, max|u - K(K^T A K)^-1 K^T b| "
              f"{err:.3e} (tol 1e-8); launches {c}", flush=True)
        if not err <= 1e-8:
            fail(f"f64 oracle {name}: error {err:.3e} > 1e-8")
        if min((c[k] for k in need), default=1) <= 0 or max((c[k] for k in forbid), default=0) != 0:
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

    from dolfinx_mpc_tpu_torch.demos import demo_contact_2D, demo_elasticity

    for name, fn in (("demo_contact_2D.main(nb=5, nt=4)", lambda: demo_contact_2D.main(nb=5, nt=4, device="cuda")),
                     ("demo_elasticity.main(n=8)", lambda: demo_elasticity.main(n=8, device="cuda"))):
        reset_counts()
        u = fn().x.array
        if u.device.type != "cuda" or not bool(torch.isfinite(u).all()):
            fail(f"{name}: the solution is not a finite tensor on the card")
        print(f"{name} on the card: its own checks passed, max|u| {float(u.abs().max()):.4e}; launches "
              f"{read_counts(KERNELS)}", flush=True)

    counts7, krylov = slice10_phases(dev)
    launches11, checks11 = slice11_phases(dev, gen)
    launches12, checks12 = slice12_phases(dev, gen, k8c)
    entry_phase(dev)
    # phase 13's launches of K1, K2, K7 and K8, per run and per rank
    spmd = {kid: {run: [r[kid] for r in ranks] for run, ranks in launches13.items()} for kid in ("K1", "K2", "K7", "K8")}
    # phase 13's kernel checks on each rank's operator: shape and relative error per rank
    spmd_vs_plain = {kid: {run: [(c["shape"], c["rel"]) for c in checks] for run, checks in vs_plain13.items()
                           if checks[0]["kernel"] == kid} for kid in ("K2", "K7", "K8")}

    src = "dolfinx_mpc_tpu_torch/csrc/lattice_kernels.cu"
    pl = "dolfinx_mpc_tpu/ops/pallas_lattice.py"
    kernels = [
        dict(name="K1 assemble_fold_lean_factored (P1 main path; error and times at 15 x 65^3 f32)",
             route="cuda", source=src, replaces=f"{pl}:411", launches=counts["K1"], **cmp["K1"],
             krylov={f"{k}_{d}": c["K1"] for (k, d), c in krylov.items()}, spmd=spmd["K1"]),
        dict(name="K2 dia_matvec (P1 main path; error and times at 65^3 f32)", route="cuda", source=src,
             replaces=f"{pl}:766", launches=counts["K2"], **cmp["K2"],
             krylov={f"{k}_{d}": c["K2"] for (k, d), c in krylov.items()},
             lattice_formats=dict(launches=launches11["K2"], n2_1=checks11["K2"]), spmd=spmd["K2"], spmd_vs_plain=spmd_vs_plain["K2"]),
        dict(name="K3 assemble_fold_lean_masked (launches: f64 oracle P1 n=6 with the non-separable "
                  "set, 15 x 7^3; error and times: P2 n=64 with that set, 230 x 65^3 f32)", route="cuda",
             source=src, replaces=f"{pl}:526", launches=counts3["K3"], **cmp["K3"]),
        dict(name="K4 assemble_fold_lean_blocked (P2 main path; error and times at 230 x 65^3 f32)",
             route="cuda", source=src, replaces=f"{pl}:708", launches=counts2["K4"], **cmp["K4"]),
        dict(name="K5 assemble_fold_lean_raw (launches: f64 oracle, Dirichlet-free P2 n=3, 230 x 4^3; error "
                  "and times: the raw blocked P2 n=64 table, 230 x 65^3 f32; device time and bound of each of "
                  "its three n=64 tables under 'tables')", route="cuda", source=src,
             replaces=f"{pl}:611", launches=counts5["K5"], **cmp["K5"]),
        dict(name="K6 blocked_matvec (P2 main path; error and times at 8 x 65^3 f32)", route="cuda", source=src,
             replaces=f"{pl}:916", launches=counts2["K6"], **cmp["K6"],
             lattice_formats=dict(launches=launches11["K6"], s2_1=checks11["K6"])),
        dict(name=f"K7 dia_matvec_bs (bs=3 path n=64, launches by grid {k7_by_grid}; error and times at 65^3 x 3 "
                  f"f32)", route="cuda", source=src, replaces=f"{pl}:835", launches=counts4["K7"],
             launches_by_grid=k7_by_grid, **cmp["K7"],
             lattice_formats=dict(launches=launches11["K7"], bs2_n2_1=checks11["K7"],
                                  offsets_65=checks11["K7 65 offsets"]), spmd=spmd["K7"], spmd_vs_plain=spmd_vs_plain["K7"]),
        dict(name=f"K8 bell_matvec (contact path NB={NB_CONTACT}/NT={NT_CONTACT}; error and times on the packed "
                  f"layout of its operator, {s8['packed_nnz']} nonzeros, f32)", route="cuda",
             source="dolfinx_mpc_tpu_torch/csrc/bell_kernels.cu", replaces="dolfinx_mpc_tpu/la/bell.py:164",
             launches=counts8["K8"], **cmp["K8"],
             slip_contact=dict(launches=counts9["K8"], packed_nnz=s9["packed_nnz"], **k8_slip),
             stokes_nest=dict(launches=counts7["K8"]), spmd=spmd["K8"], spmd_vs_plain=spmd_vs_plain["K8"]),
    ]
    # the complex instantiations (phase 12): launches on 12a / 12c, numbers
    # of complex64 at 12b's shapes, complex128's beside them
    shapes = {"K2": f"{N_COMPLEX + 1}^3 (12a's operator)", "K7": f"{N_MAIN + 1}^3 x 3, random planes",
              "K6": f"8 x {N_MAIN + 1}^3, 230 triples, random planes",
              "K8": f"contact NB={NB_CONTACT}/NT={NT_CONTACT} x e^(0.3i)"}
    for kid, name, source, replaces in (
            ("K2", "dia_matvec", src, f"{pl}:766"), ("K7", "dia_matvec_bs", src, f"{pl}:835"),
            ("K6", "blocked_matvec", src, f"{pl}:916"),
            ("K8", "bell_matvec", "dolfinx_mpc_tpu_torch/csrc/bell_kernels.cu", "dolfinx_mpc_tpu/la/bell.py:164")):
        c64, c128 = checks12[kid]["complex64"], checks12[kid]["complex128"]
        keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels.append(dict(
            name=f"{kid} {name} complex64 / complex128 (launches: phase 12 {sorted(launches12[kid])}; error and times "
                 f"at {shapes[kid]}, complex64; complex128 under 'complex128')",
            route="cuda", source=source, replaces=replaces, launches=sum(launches12[kid].values()),
            **{k: c64[k] for k in keys}, device_ms=c64["device_ms"], device_by=c64["device_by"],
            launches_by_phase=launches12[kid], complex128={k: c128[k] for k in keys + ("device_ms", "device_by")}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
