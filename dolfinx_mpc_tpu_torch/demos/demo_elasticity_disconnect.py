"""Elasticity with point-to-point constraints between DISCONNECTED bodies
(3D).

Counterpart of ``demos/demo_elasticity_disconnect.py``: disconnected 3D
bodies from a gmsh file, the floating body tied to the anchored one with
point-to-point MPCs (including the directional `vector` variant),
rigid-body nullspace, elasticity solve, K^T A K check.
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
        msh_path = mesh_path("disconnect_3d.msh")
    mesh, cell_tags, facet_tags = read_gmsh(msh_path)
    gap_lo = 1.0
    gap_hi = mesh.points[:, 2][mesh.points[:, 2] > 1.5].min()

    V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)))
    bdofs = dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0))
    bc = dmt.dirichletbc(np.zeros(3), bdofs, V)

    # tie the floating upper box at three corners (9 scalar ties pin all 6
    # rigid modes); one of them uses the directional `vector` variant
    mpc = dmt.MultiPointConstraint(V, device=device)
    corners = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0)]
    for k, (xc, yc) in enumerate(corners):
        kwargs = {}
        if k == 2:
            kwargs["vector"] = np.array([0.0, 0.0, 1.0])  # normal-direction tie
        data = create_point_to_point_constraint(
            V, np.array([xc, yc, gap_hi]), np.array([xc, yc, gap_lo]), **kwargs
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
    L = dmt.LinearForm(
        V, lambda v, c: inner(torch.stack([0.0 * c.x[0], 0.0 * c.x[0], -0.4 + 0.0 * c.x[0]]), v)
    )
    problem = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-10})
    u = problem.solve()
    arr = u.x.array.cpu().numpy().reshape(-1, 3)
    print(f"dofs={V.num_dofs} its={problem.its} max|u|={np.abs(arr).max():.4f}")
    assert np.isfinite(arr).all()
    # full ties hold at the first two corners
    for xc, yc in corners[:2]:
        bu = int(np.argmin(((V.dof_coords_blocks - [xc, yc, gap_hi]) ** 2).sum(1)))
        bl = int(np.argmin(((V.dof_coords_blocks - [xc, yc, gap_lo]) ** 2).sum(1)))
        assert np.abs(arr[bu] - arr[bl]).max() < 1e-9

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
