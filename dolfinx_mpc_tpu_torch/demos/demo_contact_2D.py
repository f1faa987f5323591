"""2D contact-slip between stacked non-matching meshes, rotated.

Counterpart of ``demos/demo_contact_2D.py``: two stacked rectangles with
non-matching interface meshes, the whole assembly rotated so the interface
normal is not axis-aligned, slip contact u_s·n_s = u_m·n_m via the averaged
facet normal, elasticity solve, K^T A K check.
"""

import numpy as np


def main(nb=8, nt=6, theta=0.35, device="cuda"):
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import Mesh, create_rectangle, meshtags
    from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import create_normal_approximation

    bot = create_rectangle((0.0, 0.0), (1.0, 1.0), (nb, nb))
    top = create_rectangle((0.0, 1.0), (1.0, 2.0), (nt, nt))
    pts = np.vstack([bot.points, top.points])
    cells = np.vstack([bot.cells, top.cells + bot.num_points])
    mesh = Mesh(pts, cells, bot.cell_type)

    # tag the interface BEFORE rotating (facet ids survive point transforms)
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts][:, :, 1], 1.0).all(axis=1)
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(on_iface & ext)
    cent_y = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 1]
    mt = meshtags(mesh, 1, iface, np.where(cent_y > 1.0, 1, 2))

    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mesh.points[:] = mesh.points @ R.T

    V = dmt.functionspace(mesh, ("Lagrange", 1, (2,)))
    nh = create_normal_approximation(V, mt, 1, device=device)
    mpc = dmt.MultiPointConstraint(V, device=device)
    mpc.create_contact_slip_condition(mt, 1, 2, nh)
    mpc.finalize()
    print(f"slip-contact slaves: {mpc.num_local_slaves}")

    def in_rot(marker):
        return lambda x: marker(R.T @ x[:2])

    bdofs = dmt.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[1], 0.0)))
    bc = dmt.dirichletbc(np.zeros(2), bdofs, V)
    tdofs = dmt.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[1], 2.0)))
    g = dmt.Function(V, device=device)
    g.interpolate(lambda x: R @ np.stack([0.0 * x[0], -0.05 + 0.0 * x[1]]))
    bc_top = dmt.dirichletbc(g, tdofs)

    mu, lam = 1.0, 1.25

    def elast(u, v, c):
        return 2 * mu * inner(sym(grad(u)), sym(grad(v))) + lam * div(u) * conj(div(v))

    a = dmt.BilinearForm(V, elast)
    L = dmt.LinearForm(V, lambda v, c: 0.0 * v.value[..., 0])  # no source
    problem = dmt.LinearProblem(a, L, mpc, bcs=[bc, bc_top], petsc_options={"ksp_rtol": 1e-11})
    u = problem.solve()
    arr = u.x.array.cpu().numpy().reshape(-1, 2)
    print(f"dofs={V.num_dofs} its={problem.its} max|u|={np.abs(arr).max():.4f}")
    assert np.abs(arr).max() > 0.01  # compression transmitted through contact

    compare_mpc_lhs(
        dmt.assemble_matrix(a, None, bcs=[bc, bc_top], device=device),
        dmt.assemble_matrix(a, mpc, bcs=[bc, bc_top]),
        mpc,
    )
    print("K^T A K verification passed")
    return u


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--nb", type=int, default=8)
    p.add_argument("--nt", type=int, default=6)
    a = p.parse_args()
    main(a.nb, a.nt, device=device(a))
