#!/usr/bin/env python3
"""Iteration counts of the JAX package on the CPU for the Krylov, eigen and
Newton paths that chip_smoke.py drives through the port (its phases B-D).

    python3 scripts/jax_krylov_counts.py lattice --n 64 --dtype f32 --ksp bcgs
    python3 scripts/jax_krylov_counts.py gep --n 128 --nev 4
    python3 scripts/jax_krylov_counts.py stokes --nx 16 --ny 8
    python3 scripts/jax_krylov_counts.py nonlinear_nest --nx 12 --ny 6
    python3 scripts/jax_krylov_counts.py nonlinear

- lattice: bench.py's P1 problem (unit cube n^3 of tets, periodic in x,
  Dirichlet 0 at y=0/1, quad_degree 1, L = 4 v) through LinearProblem with
  pc_type chebyshev (degree 3) and ksp_type bcgs or gmres (GMRES(30)),
  rtol 1e-6, atol 1e-12, max_it --max-it; the Chebyshev power iteration
  starts from numpy's default_rng(seed).standard_normal(ndofs) for each
  seed of --seeds (the probes the port's runs are given) instead of
  jax.random; --perturb scales the operator by (1 + eps) for each eps
  given and --perturb-b multiplies each entry of b by (1 + eps r_i), r
  from numpy's default_rng(1000 + seed) (rounding-level changes, as
  another summation order makes them: how far the count moves under
  them).
- gep: demos/demo_periodic_gep.main(n, nev): the eigensolver's outer and
  inner (batched CG) iteration counts.
- stokes: demos/demo_stokes.main(nx, ny): the GMRES(100) count.
- nonlinear_nest: demos/demo_stokes_nonlinear_nest.main(nx, ny): the
  Newton count.
- nonlinear: tests/test_nonlinear.py's periodic problem (-div((1+u^2)
  grad u) = 4 on an 8 x 8 unit square, periodic in x, Dirichlet 0 at y=0/1,
  NonlinearProblem with its defaults): the Newton count.

Everything in float64 unless --dtype f32 (lattice).  The demos run
unchanged; counts are read from their solver calls.  Prints one JSON line.
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _spy(module, name, seen, read):
    """Wrap module.name so that each call records read(result) in seen."""
    fn = getattr(module, name)

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        seen.update(read(out))
        return out

    setattr(module, name, wrapped)


def lattice(args, seen):
    import dolfinx_mpc_tpu as dmt
    import dolfinx_mpc_tpu.la.solvers as solvers
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube

    dtype = {"f32": np.float32, "f64": np.float64}[args.dtype]
    m = args.n
    V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V, dtype=dtype)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    import dolfinx_mpc_tpu.problem as problem

    cheb, ksolve = solvers.chebyshev_preconditioner, problem.krylov_solve
    prob = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={
        "ksp_type": args.ksp, "pc_type": "chebyshev", "ksp_rtol": 1e-6, "ksp_atol": 1e-12,
        "ksp_max_it": args.max_it})
    variants = [("A", 0.0)] + [("A", e) for e in args.perturb] + [("b", e) for e in args.perturb_b]
    for seed in args.seeds:
        for what, eps in variants:
            def seeded(A, diag, _seed=seed, **kw):
                probe = np.random.default_rng(_seed).standard_normal(diag.shape[0]).astype(dtype)
                return cheb(A, diag, probe=probe, **kw)

            def perturbed(A, b, opts, _what=what, _eps=eps, _seed=seed, **kw):
                if _eps and _what == "A":
                    A = (lambda x, _A=A: _A(x) * (1 + _eps))
                elif _eps:
                    r = np.random.default_rng(1000 + _seed).standard_normal(b.shape[0])
                    b = b * (1 + _eps * r).astype(dtype)
                return ksolve(A, b, opts, **kw)

            solvers.chebyshev_preconditioner, problem.krylov_solve = seeded, perturbed
            prob.solve()
            key = str(seed) if eps == 0.0 else f"{seed}, {what} (1{eps:+g})"
            seen.setdefault("its_by_seed", {})[key] = prob.its
    seen.update(its=prob.its, rnorm=prob.rnorm, dofs=V.num_dofs, operator=type(prob.A).__name__)


def demo(name, fn, spies):
    """Run demos/<name> through fn(module, args) with spies: (module,
    attribute path, read) triples; the path may name a class's method."""
    def run(args, seen):
        import importlib

        for module, path, read in spies:
            owner = importlib.import_module(module)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            _spy(owner, attr, seen, read)
        fn(importlib.import_module(f"demos.{name}"), args)
    return run


def nonlinear(args, seen):
    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_square

    mesh = create_unit_square(8, 8)
    V = dmt.functionspace(mesh, ("Lagrange", 1))
    bdofs = dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0))
    bc = dmt.dirichletbc(0.0, bdofs, V)
    mpc = dmt.MultiPointConstraint(V)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    u = dmt.Function(V, name="u")
    F = dmt.LinearForm(V, lambda v, c: inner((1 + c["u"].value ** 2) * grad(c["u"]), grad(v)) - 4.0 * v.value,
                       coefficients={"u": u})
    its, converged = dmt.NonlinearProblem(F, u, mpc, bcs=[bc]).solve()
    seen.update(its=its, converged=converged, max_u=float(np.asarray(u.x.array).max()), dofs=V.num_dofs)


CASES = {
    "lattice": lattice,
    "gep": demo("demo_periodic_gep", lambda d, a: d.main(a.n, a.nev),
                [("dolfinx_mpc_tpu.la", "eigsh_shift_invert",
                  lambda out: dict(outer=out[2]["outer"], inner=out[2]["inner"],
                                   lam=[float(v) for v in np.sort(np.asarray(out[0]))]))]),
    "stokes": demo("demo_stokes", lambda d, a: d.main(a.nx, a.ny),
                   [("dolfinx_mpc_tpu.la.solvers", "gmres", lambda out: dict(its=int(out[1]), rnorm=float(out[2])))]),
    "nonlinear_nest": demo("demo_stokes_nonlinear_nest", lambda d, a: d.main(a.nx, a.ny),
                           [("dolfinx_mpc_tpu.problem", "NonlinearProblemNest.solve",
                             lambda out: dict(its=int(out[0]), converged=bool(out[1])))]),
    "nonlinear": nonlinear,
}


def main():
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("case", choices=sorted(CASES))
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--nev", type=int, default=4)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=8)
    p.add_argument("--dtype", choices=("f32", "f64"), default="f64")
    p.add_argument("--ksp", choices=("bcgs", "gmres"), default="bcgs")
    p.add_argument("--max-it", type=int, default=10000)
    p.add_argument("--seeds", type=int, nargs="+", default=[0], help="lattice: probe seeds")
    p.add_argument("--perturb", type=lambda t: [float(v) for v in t.split(",")], default=[],
                   help="lattice: operator scalings 1 + eps, comma-separated (--perturb=1e-15,-1e-15)")
    p.add_argument("--perturb-b", type=lambda t: [float(v) for v in t.split(",")], default=[],
                   help="lattice: relative random changes of b, comma-separated (--perturb-b=1e-16,3e-16)")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    seen = {}
    t0 = time.time()
    CASES[args.case](args, seen)
    print(json.dumps(dict(case=args.case, **{k: v for k, v in vars(args).items() if k != "case"},
                          seconds=time.time() - t0, jax=jax.__version__, **seen)), flush=True)


if __name__ == "__main__":
    main()
