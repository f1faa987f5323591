"""2D linear elasticity with a point-dof MPC and rigid-body nullspace.

Counterpart of ``demos/demo_elasticity.py``: fixed left edge, traction via
body force, one dof tied to another with a general (dictionary)
constraint; verifies with the K^T A K check and builds the rigid-motions
nullspace.
"""

import numpy as np


def main(n=16, device="cuda"):
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square
    from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    mesh = create_unit_square(n, n)
    V = dmt.functionspace(mesh, ("Lagrange", 1, (2,)))

    bdofs = dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 0.0))
    bc = dmt.dirichletbc(np.array([0.0, 0.0]), bdofs, V)

    # tie u at (1, 1) to u at (1, 0): v0 = 0.9 v1 componentwise
    mpc = dmt.MultiPointConstraint(V, device=device)
    mpc.create_general_constraint(
        {np.array([1.0, 1.0]).tobytes(): {np.array([1.0, 0.0]).tobytes(): 0.9}}
    )
    mpc.finalize()

    mu, lam = 1.0, 1.25

    def elast(u, v, c):
        return 2 * mu * inner(sym(grad(u)), sym(grad(v))) + lam * div(u) * conj(div(v))

    a = dmt.BilinearForm(V, elast)
    L = dmt.LinearForm(V, lambda v, c: inner(torch.stack([0.0 * c.x[0], -0.5 + 0.0 * c.x[0]]), v))
    problem = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-11})
    u = problem.solve()
    arr = u.x.array.cpu().numpy()
    print(f"dofs={V.num_dofs} its={problem.its} max|u|={np.abs(arr).max():.4f}")

    compare_mpc_lhs(
        dmt.assemble_matrix(a, None, bcs=[bc], device=device),
        dmt.assemble_matrix(a, mpc, bcs=[bc]),
        mpc,
    )
    print("K^T A K verification passed")

    ns = rigid_motions_nullspace(V)
    assert ns.shape == (V.num_dofs, 3)
    # nullspace is in the kernel of the unconstrained operator without bcs
    A0 = dmt.assemble_matrix(a, None, device=device).to_scipy()
    resid = np.abs(A0 @ ns).max()
    print(f"nullspace residual |A z| = {resid:.2e}")
    assert resid < 1e-10
    # constraint satisfied
    flat_m, offs = mpc.masters
    flat_c, _ = mpc.coefficients
    for i, sd in enumerate(mpc.slaves):
        expect = sum(c * arr[m] for m, c in zip(flat_m[offs[i]:offs[i + 1]], flat_c[offs[i]:offs[i + 1]]))
        assert abs(arr[sd] - expect) < 1e-12
    print("constraint satisfied on solution")
    return u


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--n", type=int, default=16)
    a = p.parse_args()
    main(a.n, device(a))
