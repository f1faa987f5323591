"""3D Poisson, second-order elements, topologically-located periodic MPC.

Counterpart of ``demos/demo_periodic3d_topological.py``.
"""

import numpy as np


def main(n=8, degree=2, device="cuda"):
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import (
        create_unit_cube,
        locate_entities_boundary,
        meshtags,
    )

    mesh = create_unit_cube(n, n, n)
    V = dmt.functionspace(mesh, ("Lagrange", degree))

    bdofs = dmt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)
    )
    bc = dmt.dirichletbc(0.0, bdofs, V)

    facets = locate_entities_boundary(mesh, 2, lambda x: np.isclose(x[0], 1.0))
    mt = meshtags(mesh, 2, facets, 2)

    def relation(x):
        out = np.copy(x)
        out[0] = 1.0 - x[0]
        return out

    mpc = dmt.MultiPointConstraint(V, device=device)
    mpc.create_periodic_constraint_topological(V, mt, 2, relation, [bc])
    mpc.finalize()

    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    L = dmt.LinearForm(
        V, lambda v, c: (2.0 + torch.sin(2 * np.pi * c.x[2])) * v.value
    )
    problem = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-10})
    u = problem.solve()
    print(f"P{degree}: dofs={V.num_dofs} slaves={mpc.num_local_slaves} its={problem.its}")

    # periodicity check at the dof level
    arr = u.x.array.cpu().numpy()
    coords = V.dof_coords_blocks
    l = np.flatnonzero(np.isclose(coords[:, 0], 0.0))  # noqa: E741
    r = np.flatnonzero(np.isclose(coords[:, 0], 1.0))
    key = lambda i: np.lexsort((coords[i, 2], coords[i, 1]))  # noqa: E731
    err = np.abs(arr[l[key(l)]] - arr[r[key(r)]]).max()
    print(f"periodicity error = {err:.3e}")
    assert err < 1e-8
    return u


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--degree", type=int, default=2)
    a = p.parse_args()
    main(a.n, a.degree, device(a))
