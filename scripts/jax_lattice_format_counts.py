#!/usr/bin/env python3
"""Iteration counts of the JAX package on the CPU for the lattice paths that
chip_smoke.py's phase 11 drives through the port (the side formats, the
element-kernel paths), one JSON line per call.

    python3 scripts/jax_lattice_format_counts.py cells_gmg --n 64 --seeds 0 1 2 [--dtype float64]
    python3 scripts/jax_lattice_format_counts.py coefficient --n 64 --seeds 0 1 2 [--dtype float64]
    python3 scripts/jax_lattice_format_counts.py square --n 512 --seeds 0 1 2
    python3 scripts/jax_lattice_format_counts.py p2_elasticity --n 16 --seeds 0 1 2

- cells_gmg: bench.py's P1 problem (unit cube n^3 of tets, periodic in x,
  Dirichlet 0 at y=0/1, quad_degree 1, L = 4 v), in --dtype, on the "cells"
  side format, tests/test_gmg.py's preconditioner (build_gmg_hierarchy(...,
  n, 4, min_n=8) over "cells" levels, LatticeGMG with its defaults), cg to
  rtol 1e-6 (atol 1e-12, jitted); per seed, b times (1 + 1.2e-7 r), r from
  numpy's default_rng(1000 + seed) (a rounding-level change, as another
  summation order makes one; 2e-16 in float64).
- coefficient: inner(kappa grad u, grad v) with kappa = 1 + x0 x1 in P1 on
  the same mesh and constraint, in --dtype, L = 4 v, through LinearProblem
  (the fold format) with ksp cg, pc chebyshev, rtol 1e-6, atol 1e-12, the
  Chebyshev power iteration started from numpy's
  default_rng(seed).standard_normal(ndofs).
- square: demos/demo_periodic_geometrical.py's problem on the n x n unit
  square, float64, through LinearProblem (the fold format) with ksp cg,
  pc chebyshev (the same probes), rtol 1e-12.
- p2_elasticity: linear elasticity (mu = 1, lambda = 1.25, quad_degree 2)
  in ("Lagrange", 2, (3,)) on the unit cube n^3 of tets, periodic in x,
  Dirichlet 0 on y=0/1, the source (1 + x0 x2, 0.5 x1, -1), float64: the
  general assembler (the JAX package has no fold operator for a vector
  space at degree 2), assemble_vector + apply_lifting + set_bc, cg with the
  Chebyshev preconditioner (the same probes), rtol 1e-10.

--dtype (cells_gmg, coefficient; float32 by default, the other cases run
in float64).  --perturb-b adds, for each eps given, a run per seed with b
times (1 + eps r) (r as above) to the as-assembled ones.  Prints one JSON
line.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _periodic(dmt, V, bcs, dtype):
    mpc = dmt.MultiPointConstraint(V, dtype=dtype)
    rel = ((lambda x: np.stack([1.0 - x[0], x[1]])) if V.mesh.gdim == 2
           else (lambda x: np.stack([1.0 - x[0], x[1], x[2]])))
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0), rel, bcs)
    mpc.finalize()
    return mpc


def _y_planes(x):
    return np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)


def _perturbed(b, seed, eps, dtype):
    r = np.random.default_rng(1000 + seed).standard_normal(b.shape[0])
    return b * (1 + eps * r).astype(dtype)


def cells_gmg(args, seen):
    import jax
    import jax.numpy as jnp

    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu.la.gmg import LatticeGMG, build_gmg_hierarchy
    from dolfinx_mpc_tpu.la.solvers import cg
    from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice

    def make(m):
        V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
        bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, _y_planes), V)
        mpc = _periodic(dmt, V, [bc], dtype)
        a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
        return V, bc, mpc, assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="cells")

    dtype = np.dtype(args.dtype)
    eps0 = 1.2e-7 if dtype == np.float32 else 2e-16
    V, bc, mpc, clf = make(args.n)
    b0 = np.asarray(dmt.set_bc(dmt.assemble_vector(dmt.LinearForm(V, lambda v, c: 4.0 * v.value), mpc,
                                                   dtype=dtype), [bc]))
    ops, masks = build_gmg_hierarchy(lambda m: make(m)[3], args.n, 4, min_n=8)
    M = LatticeGMG(ops, free_masks=masks)
    solve = jax.jit(lambda A_, M_, b_: cg(A_.matvec, b_, M=M_, rtol=1e-6, atol=1e-12, max_it=3000))
    for seed in args.seeds:
        for eps in [eps0] + args.perturb_b:
            _, its, rnorm = solve(ops[0], M, jnp.asarray(_perturbed(b0, seed, eps, dtype)))
            key = str(seed) if eps == eps0 else f"{seed}, b (1{eps:+g})"
            seen.setdefault("its_by_seed", {})[key] = int(its)
    seen.update(dofs=V.num_dofs, levels=[tuple(o.dia.vshape) for o in ops], rnorm=float(rnorm))


def _linear_problem(args, seen, dmt, V, a, L, mpc, bcs, dtype, opts):
    import dolfinx_mpc_tpu.la.solvers as solvers
    import dolfinx_mpc_tpu.problem as problem

    cheb, ksolve = solvers.chebyshev_preconditioner, problem.krylov_solve
    prob = dmt.LinearProblem(a, L, mpc, bcs=bcs, petsc_options=opts)
    for seed in args.seeds:
        for eps in [0.0] + args.perturb_b:
            def seeded(A, diag, _seed=seed, **kw):
                probe = np.random.default_rng(_seed).standard_normal(diag.shape[0]).astype(dtype)
                return cheb(A, diag, probe=probe, **kw)

            def perturbed(A, b, o, _eps=eps, _seed=seed, **kw):
                if _eps:
                    b = _perturbed(np.asarray(b), _seed, _eps, dtype)
                return ksolve(A, b, o, **kw)

            solvers.chebyshev_preconditioner, problem.krylov_solve = seeded, perturbed
            prob.solve()
            key = str(seed) if eps == 0.0 else f"{seed}, b (1{eps:+g})"
            seen.setdefault("its_by_seed", {})[key] = prob.its
    solvers.chebyshev_preconditioner, problem.krylov_solve = cheb, ksolve
    seen.update(dofs=V.num_dofs, operator=type(prob.A).__name__,
                fold=getattr(prob.A, "fold_axis", None) is not None, rnorm=prob.rnorm)


def coefficient(args, seen):
    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube

    m = args.n
    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, _y_planes), V)
    dtype = np.dtype(args.dtype)
    mpc = _periodic(dmt, V, [bc], dtype)
    kappa = dmt.Function(V)
    kappa.interpolate(lambda x: 1.0 + x[0] * x[1])
    a = dmt.BilinearForm(V, lambda u, v, c: c["kappa"].value * inner(grad(u), grad(v)), coefficients={"kappa": kappa})
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    _linear_problem(args, seen, dmt, V, a, L, mpc, [bc], dtype,
                    {"ksp_type": "cg", "pc_type": "chebyshev", "ksp_rtol": 1e-6, "ksp_atol": 1e-12})


def square(args, seen):
    import jax.numpy as jnp

    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_square

    V = dmt.functionspace(create_unit_square(args.n, args.n), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, _y_planes), V)
    mpc = _periodic(dmt, V, [bc], np.float64)
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    L = dmt.LinearForm(V, lambda v, c: (c.x[0] * jnp.sin(5.0 * np.pi * c.x[1])
                                        + jnp.exp(-((c.x[0] - 0.5) ** 2 + (c.x[1] - 0.5) ** 2) * 50.0)) * v.value)
    _linear_problem(args, seen, dmt, V, a, L, mpc, [bc], np.float64,
                    {"ksp_type": "cg", "pc_type": "chebyshev", "ksp_rtol": 1e-12})


def p2_elasticity(args, seen):
    import jax.numpy as jnp

    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu.la.solvers import cg, chebyshev_preconditioner

    m = args.n
    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 2, (3,)))
    bc = dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, _y_planes), V)
    mpc = _periodic(dmt, V, [bc], np.float64)
    a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)),
                         quad_degree=2)
    L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0] + 0.5 * c.x[1] * v.value[..., 1]
                       - v.value[..., 2])
    A = dmt.assemble_matrix(a, mpc, bcs=[bc])
    b0 = np.asarray(dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [[bc]], mpc), [bc]))
    for seed in args.seeds:
        M = chebyshev_preconditioner(A.matvec, A.diagonal(),
                                     probe=np.random.default_rng(seed).standard_normal(V.num_dofs))
        for eps in [0.0] + args.perturb_b:
            b = jnp.asarray(_perturbed(b0, seed, eps, np.float64) if eps else b0)
            _, its, rnorm = cg(A.matvec, b, M=M, rtol=1e-10, max_it=10000)
            key = str(seed) if eps == 0.0 else f"{seed}, b (1{eps:+g})"
            seen.setdefault("its_by_seed", {})[key] = int(its)
    seen.update(dofs=V.num_dofs, rnorm=float(rnorm))


CASES = {"cells_gmg": cells_gmg, "coefficient": coefficient, "square": square, "p2_elasticity": p2_elasticity}


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("case", choices=sorted(CASES))
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--dtype", choices=("float32", "float64"), default="float32",
                   help="cells_gmg, coefficient: the assembly and solve dtype")
    p.add_argument("--perturb-b", type=lambda t: [float(v) for v in t.split(",")], default=[],
                   help="relative random changes of b, comma-separated (--perturb-b=2e-16,5e-16)")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    seen = {}
    t0 = time.time()
    CASES[args.case](args, seen)
    its = list(seen.get("its_by_seed", {}).values())
    print(json.dumps(dict(case=args.case, **{k: v for k, v in vars(args).items() if k != "case"},
                          seconds=time.time() - t0, jax=jax.__version__, range=[min(its), max(its)], **seen)),
          flush=True)


if __name__ == "__main__":
    main()
