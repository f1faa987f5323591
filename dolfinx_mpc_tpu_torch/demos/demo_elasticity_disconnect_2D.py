"""Elasticity with point-to-point constraints between DISCONNECTED bodies
(2D).

Counterpart of ``demos/demo_elasticity_disconnect_2D.py``: two disconnected
bodies loaded from a gmsh file, the floating upper body tied to the
anchored lower body by point-to-point MPCs, rigid-body nullspace,
elasticity solve, K^T A K check.
"""

import numpy as np


def main(msh_path=None, device="cuda"):
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.constraints import create_point_to_point_constraint
    from dolfinx_mpc_tpu_torch.demos.create_and_export_mesh import mesh_path
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.io import read_gmsh
    from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    if msh_path is None:
        msh_path = mesh_path("disconnect_2d.msh")
    mesh, cell_tags, facet_tags = read_gmsh(msh_path)
    gap_lo = 1.0
    gap_hi = mesh.points[:, 1][mesh.points[:, 1] > 1.5].min()  # upper body bottom

    V = dmt.functionspace(mesh, ("Lagrange", 1, (2,)))

    # anchor the lower body at its bottom edge
    bdofs = dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    bc = dmt.dirichletbc(np.array([0.0, 0.0]), bdofs, V)

    # tie the floating upper body to the lower one across the gap: two
    # point-to-point constraints (4 scalar ties) pin its 3 rigid modes
    mpc = dmt.MultiPointConstraint(V, device=device)
    for xpt in (0.0, 1.0):
        data = create_point_to_point_constraint(
            V, np.array([xpt, gap_hi]), np.array([xpt, gap_lo])
        )
        mpc.add_constraint_from_mpc_data(V, data)
    mpc.finalize()
    print(f"p2p slaves: {mpc.num_local_slaves}")

    ns = rigid_motions_nullspace(V)
    print(f"rigid-body nullspace: {len(ns)} vectors")

    mu, lam = 1.0, 1.25

    def elast(u, v, c):
        return 2 * mu * inner(sym(grad(u)), sym(grad(v))) + lam * div(u) * conj(div(v))

    a = dmt.BilinearForm(V, elast)
    L = dmt.LinearForm(V, lambda v, c: inner(torch.stack([0.0 * c.x[0], -0.4 + 0.0 * c.x[0]]), v))
    problem = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-11})
    u = problem.solve()
    arr = u.x.array.cpu().numpy().reshape(-1, 2)
    print(f"dofs={V.num_dofs} its={problem.its} max|u|={np.abs(arr).max():.4f}")

    # the tie holds: upper corner displacement equals lower partner's
    for xpt in (0.0, 1.0):
        bu = int(np.argmin(((V.dof_coords_blocks - [xpt, gap_hi]) ** 2).sum(1)))
        bl = int(np.argmin(((V.dof_coords_blocks - [xpt, gap_lo]) ** 2).sum(1)))
        assert np.abs(arr[bu] - arr[bl]).max() < 1e-10
    # upper body moved with the lower (transmitted through the ties)
    assert np.abs(arr[mesh.points[:, 1] > 1.5]).max() > 1e-4

    compare_mpc_lhs(
        dmt.assemble_matrix(a, None, bcs=[bc], device=device),
        dmt.assemble_matrix(a, mpc, bcs=[bc]),
        mpc,
    )
    print("K^T A K verification passed")
    return u


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--msh", default=None)
    a = p.parse_args()
    main(a.msh, device(a))
