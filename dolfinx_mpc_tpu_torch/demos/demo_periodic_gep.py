"""Generalized eigenproblem K u = λ M u with a periodic MPC.

Counterpart of ``demos/demo_periodic_gep.py``: shift-and-invert block
inverse iteration (``la.eig.eigsh_shift_invert``) whose inner solves are
one batched Jacobi-CG over the search block, checked against scipy's
``eigsh`` on the reduced pencil.  Slave and bc rows get ``diagval`` on the
diagonal, which moves their spurious eigenvalues to ~diagval, far from the
physical spectrum that shift-and-invert at σ=0 targets.
"""

import numpy as np


def main(n=16, nev=4, diagval=1e4, device="cuda", info=None):
    """Solve and check; `info`, a dict if given, receives the eigensolver's
    outer and inner iteration counts and the relative eigenvalue errors."""
    import scipy.sparse.linalg as spla

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square
    from dolfinx_mpc_tpu_torch.la import eigsh_shift_invert, jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix

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

    k_form = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    m_form = dmt.BilinearForm(V, lambda u, v, c: inner(u, v))
    # diagval shifts slave/bc eigenvalues to ~diagval
    K = dmt.assemble_matrix(k_form, mpc, bcs=[bc], diagval=diagval)
    M = dmt.assemble_matrix(m_form, mpc, bcs=[bc], diagval=1.0)

    # shift-and-invert at sigma=0: the smallest pencil eigenvalues become the
    # dominant ones of K^{-1} M; the inner solves are one batched Jacobi-CG
    pc = jacobi_preconditioner(K.diagonal())
    lam, U, info_si = eigsh_shift_invert(K, M, nev, sigma=0.0, pc=pc, tol=1e-8)
    print(f"smallest generalized eigenvalues: {lam} "
          f"({info_si['outer']} outer, {info_si['inner']} inner CG its)")

    # reference eigenvalues via scipy on the reduced pencil
    Ks = dmt.assemble_matrix(k_form, None, bcs=[bc], device=device).to_scipy()
    Ms = dmt.assemble_matrix(m_form, None, bcs=[bc], device=device).to_scipy()
    Kt = gather_transformation_matrix(mpc)
    # restrict the reduced pencil to non-bc reduced dofs (bc rows are
    # diagval·identity and would flood the spectrum with λ = 1)
    is_slave = np.zeros(V.num_dofs, bool)
    is_slave[np.asarray(mpc.slaves)] = True
    reduced_of_full = -np.ones(V.num_dofs, np.int64)
    reduced_of_full[~is_slave] = np.arange((~is_slave).sum())
    free = reduced_of_full[np.setdiff1d(np.flatnonzero(~is_slave), bc.dofs)]
    Kr = (Kt.T @ Ks @ Kt).tocsr()[free][:, free]
    Mr = (Kt.T @ Ms @ Kt).tocsr()[free][:, free]
    vals = np.sort(spla.eigsh(Kr, k=nev, M=Mr, sigma=0, which="LM", return_eigenvectors=False))
    print(f"scipy reference eigenvalues: {vals}")
    rel = np.abs(np.sort(lam) - vals) / vals
    for i in range(nev):
        print(f"mode {i}: {np.sort(lam)[i]:.6f} vs scipy {vals[i]:.6f} (rel {rel[i]:.2e})")
    assert rel.max() < 1e-6, f"eigenvalue mismatch: {rel}"
    if info is not None:
        info.update(outer=info_si["outer"], inner=info_si["inner"], rel=rel, dofs=V.num_dofs)
    return lam


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--n", type=int, default=16)
    p.add_argument("--nev", type=int, default=4)
    args = p.parse_args()
    main(args.n, args.nev, device=device(args))
