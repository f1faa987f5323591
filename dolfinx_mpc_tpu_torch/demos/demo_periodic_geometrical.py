"""2D Poisson with a geometrically-located periodic MPC.

Counterpart of ``demos/demo_periodic_geometrical.py``: solve -Δu = f on the
unit square with u(0, y) = u(1, y) enforced as a multi-point constraint,
Dirichlet u = 0 on y ∈ {0, 1}, CG + Jacobi, and the scipy K^T A K check.
"""

import numpy as np


def main(n=32, verify=True, device="cuda"):
    import scipy.sparse.linalg as spla
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square
    from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix

    mesh = create_unit_square(n, n)
    V = dmt.functionspace(mesh, ("Lagrange", 1))

    bdofs = dmt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)
    )
    bc = dmt.dirichletbc(0.0, bdofs, V)

    def periodic_boundary(x):
        return np.isclose(x[0], 1.0)

    def periodic_relation(x):
        out = np.copy(x)
        out[0] = 1.0 - x[0]
        return out

    mpc = dmt.MultiPointConstraint(V, device=device)
    mpc.create_periodic_constraint_geometrical(V, periodic_boundary, periodic_relation, [bc])
    mpc.finalize()

    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    L = dmt.LinearForm(
        V,
        lambda v, c: (c.x[0] * torch.sin(5.0 * np.pi * c.x[1])
                      + torch.exp(-((c.x[0] - 0.5) ** 2 + (c.x[1] - 0.5) ** 2) * 50.0)) * v.value,
    )

    problem = dmt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-12})
    u = problem.solve()
    print(f"dofs={V.num_dofs} slaves={mpc.num_local_slaves} CG its={problem.its}")

    if verify:
        A = dmt.assemble_matrix(a, None, bcs=[bc], device=device).to_scipy()
        b = dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(L, None, device=device), [a], [[bc]], None),
                       [bc]).cpu().numpy()
        K = gather_transformation_matrix(mpc)
        u_ref = K @ spla.spsolve((K.T @ A @ K).tocsr(), K.T @ b)
        err = np.abs(u.x.array.cpu().numpy() - u_ref).max()
        print(f"max |u - K(K^TAK)^-1K^Tb| = {err:.3e}")
        assert err < 1e-8
    return u


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--no-verify", action="store_true")
    args = p.parse_args()
    main(args.n, not args.no_verify, device(args))
