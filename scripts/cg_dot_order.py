#!/usr/bin/env python3
"""How the accumulation of CG's float32 dot products moves its iteration
count: the port's CG on chip_smoke.py's phase 11a problem (bench.py's P1
problem on the "cells" side format, test_gmg's GMG over "cells" levels,
rtol 1e-6, b times 1 + 1.2e-7 r with r from numpy's default_rng(1000)),
float32 on the CPU, with three dot products — torch's own (blocked
partial sums), one accumulated in float64, and one accumulated in float32
in sequence — beside the JAX package's count on the same problem.

    python3 scripts/cg_dot_order.py --n 32

Prints one JSON line: the counts and each run's residual history.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def port_counts(n):
    import torch

    import chip_smoke as cs
    import dolfinx_mpc_tpu_torch as dmt

    dev = torch.device("cpu")
    V, bc, mpc, a, _ = cs.make_problem(n, np.float32, dev, side_format="cells")
    b0 = dmt.set_bc(dmt.assemble_vector(dmt.LinearForm(V, lambda v, c: 4.0 * v.value), mpc), [bc])
    levels, masks = dmt.build_gmg_hierarchy(
        lambda m: cs.make_problem(m, np.float32, dev, side_format="cells")[4], n, 4, min_n=8)
    M = dmt.LatticeGMG(levels, free_masks=masks)
    A = levels[0].matvec
    b = cs._b_noise(b0, 0, 1.2e-7)

    def cg(dot, rtol=1e-6, atol=1e-12):
        x = torch.zeros_like(b)
        r = b - A(x)
        z = M(r)
        p, rz = z, dot(r, z)
        tol2 = max(rtol * float(torch.linalg.vector_norm(b)), atol) ** 2
        hist = []
        while len(hist) < 3000 and float(dot(r, r)) > tol2:
            Ap = A(p)
            alpha = rz / dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rz_new = dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            hist.append(float(torch.linalg.vector_norm(r.double())))
        return hist

    dots = {
        "torch": torch.dot,
        "float64": lambda u, v: torch.dot(u.double(), v.double()).float(),
        "sequential float32": lambda u, v: torch.as_tensor(np.cumsum((u * v).numpy(), dtype=np.float32)[-1]),
    }
    return {name: cg(dot) for name, dot in dots.items()}


def jax_count(n):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import dolfinx_mpc_tpu as jx
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu.la.gmg import LatticeGMG, build_gmg_hierarchy
    from dolfinx_mpc_tpu.la.solvers import cg
    from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice

    def make(m):
        V = jx.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
        bc = jx.dirichletbc(0.0, jx.locate_dofs_geometrical(
            V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
        mpc = jx.MultiPointConstraint(V, dtype=np.float32)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
        mpc.finalize()
        a = jx.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
        return V, bc, mpc, assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=np.float32, side_format="cells")

    V, bc, mpc, _ = make(n)
    b0 = np.asarray(jx.set_bc(jx.assemble_vector(jx.LinearForm(V, lambda v, c: 4.0 * v.value), mpc,
                                                 dtype=np.float32), [bc]))
    r = np.random.default_rng(1000).standard_normal(b0.shape[0])
    b = jnp.asarray(b0 * (1 + 1.2e-7 * r).astype(np.float32))
    ops, masks = build_gmg_hierarchy(lambda m: make(m)[3], n, 4, min_n=8)
    _, its, _ = jax.jit(lambda A_, M_, b_: cg(A_.matvec, b_, M=M_, rtol=1e-6, atol=1e-12, max_it=3000))(
        ops[0], LatticeGMG(ops, free_masks=masks), b)
    return int(its)


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=32)
    args = p.parse_args()
    hist = port_counts(args.n)
    print(json.dumps(dict(n=args.n, port_its={k: len(h) for k, h in hist.items()}, jax_its=jax_count(args.n),
                          residuals={k: [float(f"{v:.3e}") for v in h] for k, h in hist.items()})), flush=True)


if __name__ == "__main__":
    main()
