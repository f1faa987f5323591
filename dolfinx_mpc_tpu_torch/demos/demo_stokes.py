"""Stokes flow in a rotated channel with slip MPC — ONE mixed-space matrix.

Counterpart of ``demos/demo_stokes.py``: Taylor-Hood P2-P1 in a single
mixed space, u·n = 0 on the non-axis-aligned walls as a slip MPC on the
velocity sub-space, parabolic inflow, single-matrix assembly, GMRES(100)
with Jacobi, and the slip and K^T A K checks.
"""

import numpy as np


def main(nx=16, ny=8, theta=np.pi / 7, device="cuda", info=None):
    """Solve and check; `info`, a dict if given, receives the GMRES count
    and residual norm."""
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_rectangle, locate_entities_boundary, meshtags
    from dolfinx_mpc_tpu_torch.la.solvers import gmres, jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import create_normal_approximation

    L_ch, H_ch = 2.0, 1.0
    mesh = create_rectangle((0, 0), (L_ch, H_ch), (nx, ny))
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mesh.points[:] = mesh.points @ R.T

    # ONE mixed Taylor-Hood space: velocity P2 vector + pressure P1
    W = dmt.mixed_functionspace(mesh, [("Lagrange", 2, (2,)), ("Lagrange", 1)])
    Wv = W.sub(0)

    def in_rotated(marker):
        return lambda x: marker(R.T @ x[:2])

    wall_facets = locate_entities_boundary(
        mesh, 1, in_rotated(lambda X: np.isclose(X[1], 0.0) | np.isclose(X[1], H_ch))
    )
    mt = meshtags(mesh, 1, wall_facets, 1)

    inflow_dofs = dmt.locate_dofs_geometrical(Wv, in_rotated(lambda X: np.isclose(X[0], 0.0)))
    g = dmt.Function(Wv, name="g", device=device)

    def inflow(x):
        X = np.linalg.inv(R) @ x[:2]
        return R @ np.stack([4.0 * X[1] * (H_ch - X[1]), np.zeros_like(X[1])])

    g.interpolate(inflow)
    bc_in = dmt.dirichletbc(g, inflow_dofs)

    # slip MPC on the velocity field of the mixed space
    nh = create_normal_approximation(Wv, mt, 1, device=device)
    mpc = dmt.MultiPointConstraint(W, device=device)
    mpc.create_slip_constraint(Wv, (mt, 1), nh, [bc_in])
    mpc.finalize()
    print(f"slip slaves: {mpc.num_local_slaves}")

    a = dmt.BilinearForm(
        W,
        lambda u, v, c: inner(grad(u[0]), grad(v[0]))
        - div(v[0]) * conj(u[1].value)
        - div(u[0]) * conj(v[1].value),
    )
    L = dmt.LinearForm(W, lambda v, c: inner(0.0 * c.x, v[0]) + 0.0 * v[1].value)

    A = dmt.assemble_matrix(a, mpc, bcs=[bc_in])
    b = dmt.assemble_vector(L, mpc)
    b = dmt.apply_lifting(b, [a], [[bc_in]], mpc)
    b = dmt.set_bc(b, [bc_in])

    x, its, rnorm = gmres(A.matvec, b, M=jacobi_preconditioner(A.diagonal()), rtol=1e-10, restart=100,
                          max_it=20000)
    x = mpc.finalized.backsubstitution(x)
    u = dmt.Function(W, x, device=device)
    uv, p = dmt.split(u)
    print(f"dofs={W.num_dofs} gmres its={its} rnorm={rnorm:.2e}")
    if info is not None:
        info.update(its=its, rnorm=rnorm, dofs=W.num_dofs)

    # slip holds on the wall
    nvals = nh.x.array.cpu().numpy().reshape(-1, 2)
    uu = uv.x.array.cpu().numpy().reshape(-1, 2)
    wall_blocks = dmt.locate_dofs_topological(Wv, 1, wall_facets)
    un = np.abs((uu[wall_blocks] * nvals[wall_blocks]).sum(1)).max()
    print(f"max |u·n| on wall: {un:.2e}")
    assert un < 1e-8
    assert np.abs(uu).max() > 0.5  # flow developed

    compare_mpc_lhs(
        dmt.assemble_matrix(a, None, bcs=[bc_in], device=device).to_scipy(),
        dmt.assemble_matrix(a, mpc, bcs=[bc_in]).to_scipy(),
        mpc,
    )
    print("K^T A K verification passed")
    return u


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=8)
    args = p.parse_args()
    main(args.nx, args.ny, device=device(args))
