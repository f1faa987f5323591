"""3D tied contact between two stacked cubes with non-matching interfaces.

Counterpart of ``demos/demo_contact_3D.py``: structured stacked cubes, tied
(inelastic) contact, per-phase timings with ``--timing``.
"""

import time

import numpy as np


def stacked_cubes(nb, nt):
    from dolfinx_mpc_tpu_torch.fem.mesh import Mesh, create_box

    bot = create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    pts = np.vstack([bot.points, top.points])
    cells = np.vstack([bot.cells, top.cells + bot.num_points])
    return Mesh(pts, cells, bot.cell_type)


def main(nb=4, nt=3, timing=False, device="cuda"):
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import meshtags
    from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs

    mesh = stacked_cubes(nb, nt)
    V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)))

    # tag interface facets at z=1: 1 = top side (slave), 2 = bottom side (master)
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts][:, :, 2], 1.0).all(axis=1)
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(on_iface & ext)
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    mt = meshtags(mesh, 2, iface, np.where(cz > 1.0, 1, 2))

    t0 = time.time()
    mpc = dmt.MultiPointConstraint(V, device=device)
    mpc.create_contact_inelastic_condition(mt, 1, 2)
    mpc.finalize()
    t_constraint = time.time() - t0

    bdofs = dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0))
    bc = dmt.dirichletbc(np.array([0.0, 0.0, 0.0]), bdofs, V)
    tdofs = dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 2.0))
    bc_top = dmt.dirichletbc(np.array([0.0, 0.0, -0.1]), tdofs, V)

    mu, lam = 1.0, 1.25

    def elast(u, v, c):
        return 2 * mu * inner(sym(grad(u)), sym(grad(v))) + lam * div(u) * conj(div(v))

    a = dmt.BilinearForm(V, elast)
    L = dmt.LinearForm(V, lambda v, c: 0.0 * v.value[..., 0])  # no source

    t0 = time.time()
    problem = dmt.LinearProblem(a, L, mpc, bcs=[bc, bc_top], petsc_options={"ksp_rtol": 1e-10})
    u = problem.solve()
    t_solve = time.time() - t0
    print(f"dofs={V.num_dofs} slaves={mpc.num_local_slaves} its={problem.its}")
    if timing:
        print(f"~MPC: constraint init {t_constraint:.3f}s, assemble+solve {t_solve:.3f}s")

    # displacement continuous across the non-matching interface
    probe = np.array([[0.31, 0.47, 1.0 - 1e-10], [0.31, 0.47, 1.0 + 1e-10]])
    vals = u.eval(probe)
    gap = np.abs(vals[0] - vals[1]).max()
    print(f"interface displacement jump = {gap:.3e}")
    assert gap < 1e-6

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
    p.add_argument("--nb", type=int, default=4)
    p.add_argument("--nt", type=int, default=3)
    p.add_argument("--timing", action="store_true")
    a = p.parse_args()
    main(a.nb, a.nt, a.timing, device(a))
