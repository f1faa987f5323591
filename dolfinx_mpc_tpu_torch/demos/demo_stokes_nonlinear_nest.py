"""Nonlinear Stokes (velocity-dependent viscosity) on block (nest) systems.

Counterpart of ``demos/demo_stokes_nonlinear_nest.py``: Newton through
NonlinearProblemNest with Jacobian blocks from ``derivative``, a slip MPC on
the velocity block of a rotated channel, and the convergence and slip
checks.
"""

import numpy as np


def main(nx=12, ny=6, theta=np.pi / 7, eps=0.05, device="cuda", info=None):
    """Solve and check; returns (u, p).  `info`, a dict if given, receives
    the Newton count."""
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, dot, grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_rectangle, locate_entities_boundary, meshtags
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import create_normal_approximation

    L_ch, H_ch = 2.0, 1.0
    mesh = create_rectangle((0, 0), (L_ch, H_ch), (nx, ny))
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mesh.points[:] = mesh.points @ R.T
    V = dmt.functionspace(mesh, ("Lagrange", 2, (2,)))
    Q = dmt.functionspace(mesh, ("Lagrange", 1))

    def in_rot(marker):
        return lambda x: marker(R.T @ x[:2])

    wall = locate_entities_boundary(
        mesh, 1, in_rot(lambda X: np.isclose(X[1], 0.0) | np.isclose(X[1], H_ch))
    )
    mt = meshtags(mesh, 1, wall, 1)
    inflow_dofs = dmt.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[0], 0.0)))
    g = dmt.Function(V, device=device)

    def inflow(x):
        X = np.linalg.inv(R) @ x[:2]
        return R @ np.stack([4.0 * X[1] * (H_ch - X[1]), np.zeros_like(X[1])])

    g.interpolate(inflow)
    bc_in = dmt.dirichletbc(g, inflow_dofs)

    nh = create_normal_approximation(V, mt, 1, device=device)
    mpc_v = dmt.MultiPointConstraint(V, device=device)
    mpc_v.create_slip_constraint(V, (mt, 1), nh, [bc_in])
    mpc_v.finalize()
    mpc_q = dmt.MultiPointConstraint(Q, device=device)
    mpc_q.finalize()

    u = dmt.Function(V, name="u", device=device)
    p = dmt.Function(Q, name="p", device=device)

    # residual blocks: nu(u) = 1 + eps |u|^2 (shear-thickening viscosity)
    F0 = dmt.LinearForm(
        V,
        lambda v, c: (1.0 + eps * dot(c["u"].value, c["u"].value))
        * inner(grad(c["u"]), grad(v))
        - div(v) * conj(c["p"].value),
        coefficients={"u": u, "p": p},
    )
    F1 = dmt.LinearForm(
        Q, lambda q, c: -div(c["u"]) * conj(q.value), coefficients={"u": u, "p": p}
    )

    prob = dmt.NonlinearProblemNest(
        [F0, F1], [u, p], [mpc_v, mpc_q], bcs=[bc_in], u_names=["u", "p"],
        petsc_options={"ksp_type": "gmres", "ksp_rtol": 1e-12, "ksp_max_it": 20000},
        rtol=1e-9, atol=1e-9, max_it=20,
    )
    its, converged = prob.solve()
    print(f"Newton its={its} converged={converged}")
    if info is not None:
        info.update(its=its, converged=converged, dofs=V.num_dofs + Q.num_dofs)
    assert converged

    uv = u.x.array.cpu().numpy().reshape(-1, 2)
    nvals = nh.x.array.cpu().numpy().reshape(-1, 2)
    wall_blocks = dmt.locate_dofs_topological(V, 1, wall)
    un = np.abs((uv[wall_blocks] * nvals[wall_blocks]).sum(1)).max()
    print(f"max |u·n| on wall: {un:.2e}; max|u| = {np.abs(uv).max():.3f}")
    assert un < 1e-8 and np.abs(uv).max() > 0.5
    return u, p


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--nx", type=int, default=12)
    p.add_argument("--ny", type=int, default=6)
    args = p.parse_args()
    main(args.nx, args.ny, device=device(args))
