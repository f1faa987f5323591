"""Stokes flow in a rotated channel with slip MPC — block (nest) assembly.

Counterpart of ``demos/demo_stokes_nest.py``: Taylor-Hood P2-P1 on a
channel rotated so the walls are not axis aligned, u·n = 0 on the walls as
a slip MPC built from the averaged facet normal, parabolic inflow, nest
assembly, BiCGStab with a block-diagonal preconditioner (Chebyshev degree 5
on the velocity block, pressure-mass Jacobi), and the slip check.

``problem`` builds the nest system and ``preconditioner`` the fieldsplit
preconditioner, so that other drivers (chip_smoke.py, which turns the
blocks into BELL operators with ``NestMatrix.to_bell`` so that every block
matvec on the card is one K8 launch) can time them; ``main`` runs both,
the solve and the checks.
"""

from types import SimpleNamespace

import numpy as np


def problem(nx=16, ny=8, theta=np.pi / 7, device="cuda"):
    """The nest system: a SimpleNamespace with V, Q, the constraints
    mpc / mpc_q, the normal nh, the NestMatrix A (slot CSR blocks), the
    right-hand side rhs and the pressure mass diagonal mass_q."""
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_rectangle, locate_entities_boundary, meshtags
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import create_normal_approximation

    L_ch, H_ch = 2.0, 1.0
    mesh = create_rectangle((0, 0), (L_ch, H_ch), (nx, ny))
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mesh.points[:] = mesh.points @ R.T  # rotate the whole channel

    V = dmt.functionspace(mesh, ("Lagrange", 2, (2,)))
    Q = dmt.functionspace(mesh, ("Lagrange", 1))

    def in_rotated(marker):
        return lambda x: marker(R.T @ x[:2])

    wall_facets = locate_entities_boundary(
        mesh, 1, in_rotated(lambda X: np.isclose(X[1], 0.0) | np.isclose(X[1], H_ch))
    )
    mt = meshtags(mesh, 1, wall_facets, 1)

    # inflow: parabolic profile rotated into the channel frame
    inflow_dofs = dmt.locate_dofs_geometrical(V, in_rotated(lambda X: np.isclose(X[0], 0.0)))
    g = dmt.Function(V, name="g", device=device)

    def inflow(x):
        X = np.linalg.inv(R) @ x[:2]
        return R @ np.stack([4.0 * X[1] * (H_ch - X[1]), np.zeros_like(X[1])])

    g.interpolate(inflow)
    bc_in = dmt.dirichletbc(g, inflow_dofs)

    nh = create_normal_approximation(V, mt, 1, device=device)
    mpc = dmt.MultiPointConstraint(V, device=device)
    mpc.create_slip_constraint(V, (mt, 1), nh, [bc_in])
    mpc.finalize()
    mpc_q = dmt.MultiPointConstraint(Q, device=device)
    mpc_q.finalize()

    a00 = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    a01 = dmt.BilinearForm(V, lambda p, v, c: -div(v) * conj(p.value), V_trial=Q)
    a10 = dmt.BilinearForm(Q, lambda u, q, c: -div(u) * conj(q.value), V_trial=V)
    a_nest = [[a00, a01], [a10, None]]
    A = dmt.create_matrix_nest(a_nest, [mpc, mpc_q])
    dmt.assemble_matrix_nest(A, a_nest, [mpc, mpc_q], bcs=[bc_in])

    L0 = dmt.LinearForm(V, lambda v, c: inner(0.0 * c.x, v))
    L1 = dmt.LinearForm(Q, lambda q, c: 0.0 * q.value)
    b = dmt.create_vector_nest([L0, L1], [mpc, mpc_q])
    dmt.assemble_vector_nest(b, [L0, L1], [mpc, mpc_q])
    b0 = dmt.apply_lifting(b.parts[0], [a00], [[bc_in]], mpc)
    # bc columns of the divergence block lift into the pressure rhs as well
    b.parts[1] = dmt.apply_lifting(b.parts[1], [a10], [[bc_in]], mpc_q)
    b0 = dmt.set_bc(b0, [bc_in])
    rhs = torch.cat([b0, b.parts[1]])
    mass_q = dmt.assemble_matrix(dmt.BilinearForm(Q, lambda p, q, c: inner(p, q)), mpc_q).diagonal()
    return SimpleNamespace(V=V, Q=Q, mpc=mpc, mpc_q=mpc_q, nh=nh, A=A, rhs=rhs, mass_q=mass_q)


def preconditioner(A, mass_q, probe=None):
    """Fieldsplit-style block-diagonal preconditioner: Chebyshev degree 5
    (lmin_frac 0.03, power iteration from `probe`) on the velocity block,
    pressure-mass Jacobi."""
    import torch

    from dolfinx_mpc_tpu_torch.la.solvers import chebyshev_preconditioner
    from dolfinx_mpc_tpu_torch.ops.nest import block_diag_preconditioner

    A00 = A.blocks[0][0]
    Mv = chebyshev_preconditioner(A00.matvec, A00.diagonal(), degree=5, lmin_frac=0.03, probe=probe)
    inv_q = torch.where(mass_q != 0, 1.0 / mass_q, torch.ones_like(mass_q))
    return block_diag_preconditioner([Mv, lambda r: inv_q * r], A.row_sizes)


def main(nx=16, ny=8, theta=np.pi / 7, probe=None, device="cuda", info=None):
    """Solve and check; returns (u, p) as arrays.  `probe` starts the
    Chebyshev power iteration (default: the port's seeded one); `info`, a
    dict if given, receives the BiCGStab count and residual norm."""
    from dolfinx_mpc_tpu_torch.la.solvers import bicgstab

    pb = problem(nx, ny, theta, device)
    M = preconditioner(pb.A, pb.mass_q, probe)
    x, its, rnorm = bicgstab(pb.A.matvec, pb.rhs, M=M, rtol=1e-10, max_it=4000)
    V, Q, mpc = pb.V, pb.Q, pb.mpc
    u_arr = mpc.finalized.backsubstitution(x[: V.num_dofs]).cpu().numpy()
    p_arr = x[V.num_dofs:].cpu().numpy()
    print(f"V dofs={V.num_dofs} Q dofs={Q.num_dofs} slaves={mpc.num_local_slaves} its={its} rnorm={rnorm:.2e}")
    if info is not None:
        info.update(its=its, rnorm=rnorm, dofs=V.num_dofs + Q.num_dofs)

    # slip satisfied: u·n = 0 on wall slave blocks
    arr = u_arr.reshape(-1, 2)
    nvals = pb.nh.x.array.cpu().numpy().reshape(-1, 2)
    sb = np.unique(np.asarray(mpc.slaves) // 2)
    un = np.einsum("bi,bi->b", arr[sb], nvals[sb])
    print(f"max |u·n| on wall = {np.abs(un).max():.3e}")
    assert np.abs(un).max() < 1e-8
    assert np.abs(arr).max() > 0.5  # flow actually happening
    return u_arr, p_arr


if __name__ == "__main__":
    from dolfinx_mpc_tpu_torch.demos._cli import device, parser

    p = parser(__doc__)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=8)
    args = p.parse_args()
    main(args.nx, args.ny, device=device(args))
