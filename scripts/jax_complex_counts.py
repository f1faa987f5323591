#!/usr/bin/env python3
"""Iteration counts of the JAX package on the CPU for chip_smoke.py's phase
12a problem, one JSON line per call.

    JAX_PLATFORMS=cpu python3 scripts/jax_complex_counts.py --n 64 --dtype complex128 --seeds 0 1 2 --perturb-b=2e-16
    JAX_PLATFORMS=cpu python3 scripts/jax_complex_counts.py --n 64 --dtype complex64 --seeds 0 1 2 --perturb-b=1.2e-7

The problem: P1 on the unit cube n^3 of tets (bench.py's mesh), u(1, y, z)
= e^{i pi/3} u(0, y, z) (a Bloch phase: create_periodic_constraint_geometrical
with scale), Dirichlet 0 at y=0/1, inner(grad u, grad v) at quad_degree 1,
the complex source (4 + 2i x0) v; the "csr" side format (fold refuses the
phase); b = set_bc(assemble_vector(L, mpc)); cg to rtol 1e-6 (atol 1e-12,
jitted) with the Chebyshev preconditioner, its power iteration started from
numpy's default_rng(seed).standard_normal(ndofs) for each seed, once with b
as assembled and, for each eps of --perturb-b, with b times (1 + eps r), r
from numpy's default_rng(1000 + seed) (a rounding-level change, as another
summation order makes one).  The JAX package's LatticeGMG is not run: its
coarse inverse drops the imaginary part of a complex coarse level (ROADMAP
queue 3), so chip_smoke.py gates the port's GMG count against its own
complex128 count instead.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

BLOCH = np.exp(1j * np.pi / 3)


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--dtype", choices=("complex64", "complex128"), default="complex128")
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--perturb-b", type=float, nargs="*", default=[])
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu.la.solvers import cg, chebyshev_preconditioner
    from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice

    t0 = time.time()
    dtype = np.dtype(args.dtype)
    m = args.n
    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V, dtype=dtype)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc], scale=BLOCH)
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    L = dmt.LinearForm(V, lambda v, c: (4.0 + 2j * c.x[0]) * v.value)
    A = assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="csr").assemble()
    b0 = np.asarray(dmt.set_bc(dmt.assemble_vector(L, mpc, dtype=dtype), [bc]))
    seen = {}
    rnorm = None
    for seed in args.seeds:
        probe = np.random.default_rng(seed).standard_normal(V.num_dofs).astype(dtype)
        M = chebyshev_preconditioner(A.matvec, A.diagonal(), probe=jnp.asarray(probe))
        solve = jax.jit(lambda A_, b_, M=M: cg(A_.matvec, b_, M=M, rtol=1e-6, atol=1e-12, max_it=3000))
        for eps in [0.0] + args.perturb_b:
            b = b0
            if eps:
                r = np.random.default_rng(1000 + seed).standard_normal(b0.shape[0])
                b = b0 * (1 + eps * r).astype(dtype)
            _, its, rn = solve(A, jnp.asarray(b))
            key = str(seed) if eps == 0.0 else f"{seed}, b (1{eps:+g})"
            seen[key] = int(its)
            rnorm = float(rn)
    vals = list(seen.values())
    print(json.dumps({"case": "bloch_csr_chebyshev", "n": m, "dtype": args.dtype, "dofs": V.num_dofs,
                      "its_by_seed": seen, "range": [min(vals), max(vals)], "rnorm": rnorm,
                      "bnorm": float(np.linalg.norm(b0)), "seconds": round(time.time() - t0, 1),
                      "jax": jax.__version__}))


if __name__ == "__main__":
    main()
