"""Time-dependent linear wave equation with a periodic MPC.

Counterpart of ``demos/demo_linear_wave_problem.py``: u_tt = c² Δu,
implicit Newmark-β stepping, periodic in x; the constrained operators are
assembled ONCE and reused every step, so a step is one matvec and one CG
solve (the JAX demo's jitted step is a plain function here).
"""

import numpy as np


def main(n=24, steps=40, dt=0.01, c2=1.0, device="cuda"):
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square
    from dolfinx_mpc_tpu_torch.la.solvers import cg, jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.ops.assemble import MPCMatrix

    mesh = create_unit_square(n, n)
    V = dmt.functionspace(mesh, ("Lagrange", 1))
    bdofs = dmt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)
    )
    bc = dmt.dirichletbc(0.0, bdofs, V)
    mpc = dmt.MultiPointConstraint(V, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc]
    )
    mpc.finalize()

    m_form = dmt.BilinearForm(V, lambda u, v, c: inner(u, v))
    k_form = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    # Newmark (β = 1/4): (M + β dt² c² K) a_{n+1} = -c² K (u_n + dt v_n + dt²/4 a_n)
    M = dmt.assemble_matrix(m_form, mpc, bcs=[bc])
    K = dmt.assemble_matrix(k_form, mpc, bcs=[bc], diagval=0.0)
    beta, gamma = 0.25, 0.5
    Adata = M.data + beta * dt * dt * c2 * K.data
    A = type(M)(Adata, M.indices, M.indptr, M.row_ids, M.shape)
    assert isinstance(A, MPCMatrix)
    Mdiag = A.diagonal()
    fmpc = mpc.finalized

    u = dmt.Function(V, device=device)
    u.interpolate(lambda x: np.sin(2 * np.pi * x[0]) * np.sin(np.pi * x[1]))
    un = fmpc.backsubstitution(u.x.array)
    vn = torch.zeros_like(un)
    an = torch.zeros_like(un)
    pc = jacobi_preconditioner(Mdiag)

    def step(un, vn, an):
        pred = un + dt * vn + dt * dt * (0.5 - beta) * an
        rhs = -c2 * K.matvec(pred)
        rhs = fmpc.homogenize(rhs)  # bc rows stay 0
        a_new, _, _ = cg(A.matvec, rhs, M=pc, rtol=1e-10, max_it=500)
        u_new = pred + beta * dt * dt * a_new
        v_new = vn + dt * ((1 - gamma) * an + gamma * a_new)
        u_new = fmpc.backsubstitution(u_new)
        return u_new, v_new, a_new

    e0 = None
    for s in range(steps):
        un, vn, an = step(un, vn, an)
        if s % 10 == 0 or s == steps - 1:
            ke = 0.5 * float(torch.vdot(vn, M.matvec(vn)).real)
            pe = 0.5 * c2 * float(torch.vdot(un, K.matvec(un)).real)
            if e0 is None:
                e0 = ke + pe
            print(f"step {s:3d}: KE={ke:.6f} PE={pe:.6f} E={ke+pe:.6f}")
    drift = abs((ke + pe) - e0) / e0
    print(f"relative energy drift over {steps} steps: {drift:.2e}")
    assert drift < 0.02, "Newmark energy drift too large"
    # periodicity maintained
    coords = V.dof_coords_blocks
    l = np.flatnonzero(np.isclose(coords[:, 0], 0.0))  # noqa: E741
    r = np.flatnonzero(np.isclose(coords[:, 0], 1.0))
    ls, rs = l[np.argsort(coords[l, 1])], r[np.argsort(coords[r, 1])]
    arr = un.cpu().numpy()
    assert np.abs(arr[ls] - arr[rs]).max() < 1e-9
    print("periodicity maintained through time stepping")
    return un


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--n", type=int, default=24)
    p.add_argument("--steps", type=int, default=40)
    a = p.parse_args()
    main(a.n, a.steps, device=device(a))
