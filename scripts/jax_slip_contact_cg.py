#!/usr/bin/env python3
"""CG iterations of the JAX package on the rotated slip-contact problem,
on the CPU: the reference count that chip_smoke.py holds the port's
slip-contact path to.

    python3 scripts/jax_slip_contact_cg.py [--nb 24] [--nt 20]

The problem is chip_smoke.make_slip_contact's, built here with the JAX
package: two stacked P1 vector tet boxes, (0,0,0)-(1,1,1) with nb^3 and
(0,0,1)-(1,1,2) with nt^3 cells, the interface facets tagged 1 (top side)
and 2 (bottom side) and the top box's x=0 side facets 3, every point then
rotated by rotation_matrix([1, 1, 0], 0.3); the slave normal from
create_normal_approximation(V, mt, 1) (the port takes
facet_normal_approximation(..., method="project"), which on this flat
interface equals the averaged normal to 1e-8, chip_smoke.py's normal gate;
the JAX package's projected normal is not used, since its exterior-facet
normal is inward on negatively oriented tets, ROADMAP queue 3); the constraint
create_contact_slip_condition(mt, 1, 2, n); Dirichlet 0 at Z=0 and
R (0, 0, -0.05) at Z=2 (markers in the unrotated frame); 2 mu
sym(grad u):sym(grad v) + lambda div u div v with mu=1, lambda=1.25; the
traction R (0.1, 0, 0) on tag 3 as an exterior-facet term.  The solve is
the contact benchmark's all-f32 recipe: constraint and assembly in float64;
BELL, AMG (rigid-body near-nullspace), b and CG (rtol 1e-6, atol 1e-12) in
float32, CG jitted.  Prints one JSON line.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--nb", type=int, default=24)
    p.add_argument("--nt", type=int, default=20)
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu.fem.mesh import Mesh, create_box, meshtags
    from dolfinx_mpc_tpu.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu.la.bell import bell_from_scipy
    from dolfinx_mpc_tpu.la.solvers import cg
    from dolfinx_mpc_tpu.utils.mpc_utils import (
        create_normal_approximation,
        rigid_motions_nullspace,
        rotation_matrix,
    )

    nb, nt = args.nb, args.nt
    bot = create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                bot.cell_type)
    fverts, _, f2c = mesh.facets()
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    on_iface = np.isclose(mesh.points[fverts][:, :, 2], 1.0).all(axis=1)
    iface = np.flatnonzero(on_iface & ext)
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    side = np.flatnonzero(np.isclose(mesh.points[fverts][:, :, 0], 0.0).all(axis=1) & ext
                          & (mesh.points[fverts][:, :, 2] >= 1.0).all(axis=1))
    mt = meshtags(mesh, 2, np.concatenate([iface, side]),
                  np.concatenate([np.where(cz > 1.0, 1, 2), np.full(len(side), 3)]))
    R = rotation_matrix([1.0, 1.0, 0.0], 0.3)
    mesh.points[:] = mesh.points @ R.T

    V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)))
    n = create_normal_approximation(V, mt, 1)
    mpc = dmt.MultiPointConstraint(V)
    mpc.create_contact_slip_condition(mt, 1, 2, n)
    mpc.finalize()

    def in_rot(marker):
        return lambda x: marker(R.T @ x[:3])

    bcs = [dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[2], 0.0))), V),
           dmt.dirichletbc(R @ np.array([0.0, 0.0, -0.05]),
                           dmt.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[2], 2.0))), V)]
    a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)))
    L = dmt.LinearForm(V, lambda v, c: inner(c["t"], v), integral="exterior_facet", entities=mt.find(3),
                       constants={"t": R @ np.array([0.1, 0.0, 0.0])})
    A = dmt.assemble_matrix(a, mpc, bcs=bcs)
    b = jnp.asarray(np.asarray(dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)),
                    jnp.float32)
    As = A.to_scipy()
    B = bell_from_scipy(As, dtype=np.float32)
    M = smoothed_aggregation_amg(As, bs=3, dtype=np.float32, nullspace=rigid_motions_nullspace(V))
    _, its, rnorm = jax.jit(lambda B_, M_, b_: cg(B_.matvec, b_, M=M_, rtol=1e-6, atol=1e-12,
                                                  max_it=3000))(B, M, b)
    print(json.dumps(dict(nb=nb, nt=nt, dofs=V.num_dofs, slaves=mpc.num_local_slaves, its=int(its),
                          rnorm=float(rnorm), bnorm=float(jnp.linalg.norm(b)))))


if __name__ == "__main__":
    main()
