#!/usr/bin/env python3
"""BiCGStab iterations of the JAX package on demo_stokes_nest's problem, on
the CPU: the reference count that chip_smoke.py holds the port's nest
Stokes path to.

    python3 scripts/jax_stokes_nest_count.py [--nx 128] [--ny 64]

Runs ``demos/demo_stokes_nest.main(nx, ny)`` (Taylor-Hood P2-P1 on the
channel rotated by pi/7, slip MPC on the walls, nest assembly, BiCGStab to
rtol 1e-10 with Chebyshev degree 5 on the velocity block and pressure-mass
Jacobi) unchanged, in float64, with one substitution: the Chebyshev power
iteration starts from numpy's default_rng(seed).standard_normal(V.num_dofs)
instead of jax.random, the probe the port's path is given too, for each
seed of --seeds.  The count and the residual are read from the demo's
bicgstab call.  --perturb-b (default 0) runs each seed once per eps given,
with each entry of the right-hand side multiplied by (1 + eps r_i), r
from numpy's default_rng(1000 + seed) (a rounding-level change, as another
summation order makes it: how far the count moves under it).  Prints one
JSON line per run.
"""

import argparse
import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nx", type=int, default=128)
    p.add_argument("--ny", type=int, default=64)
    p.add_argument("--seeds", type=int, nargs="+", default=[0])
    p.add_argument("--perturb-b", type=lambda t: [float(v) for v in t.split(",")], default=[0.0],
                   help="relative random changes of b, comma-separated (--perturb-b=0,2e-16)")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import dolfinx_mpc_tpu.la.solvers as solvers
    from demos import demo_stokes_nest

    seen = {}
    cheb, bicgstab = solvers.chebyshev_preconditioner, solvers.bicgstab

    seed, eps = [0], [0.0]

    def seeded_cheb(A, diag, **kw):
        probe = np.random.default_rng(seed[0]).standard_normal(diag.shape[0])
        return cheb(A, diag, probe=probe, **kw)

    @functools.wraps(bicgstab)
    def counted(A, b, **kw):
        if eps[0]:
            b = b * (1 + eps[0] * np.random.default_rng(1000 + seed[0]).standard_normal(b.shape[0]))
        x, its, rnorm = bicgstab(A, b, **kw)
        seen.update(its=int(its), rnorm=float(rnorm), dofs=int(b.shape[0]))
        return x, its, rnorm

    solvers.chebyshev_preconditioner, solvers.bicgstab = seeded_cheb, counted
    for s in args.seeds:
        for e in args.perturb_b:
            seed[0], eps[0] = s, e
            t0 = time.time()
            demo_stokes_nest.main(args.nx, args.ny)
            print(json.dumps(dict(case="stokes_nest", nx=args.nx, ny=args.ny, seed=s, perturb_b=e,
                                  seconds=time.time() - t0, jax=jax.__version__, **seen)), flush=True)


if __name__ == "__main__":
    main()
