"""Parity of the port's mixed spaces, rectangular assembly and nest blocks
with the JAX package: fem/mixed.py (field-stacked dofmaps, sub-space views,
split), the mixed branches of the element kernels (ops/kernels.py), slip
and periodic constraints on a sub-space, the single-matrix Taylor-Hood
Stokes system, rectangular (two-constraint) assembly, NestMatrix /
NestVector (ops/nest.py) and the Taylor-Hood channel flow of order 2 and 3
on tets and hexes.

Mirrors tests/test_mixed_space.py, tests/test_stokes_channelflow.py and
tests/test_rectangular_and_nest.py on the same inputs (real dtypes; the
complex128 cases are in tests/test_torch_complex.py).  Tolerances: host tables (dofmaps, slaves, masters,
coefficients) bit-equal; assembled matrices and vectors 1e-12 relative to
their largest entry; solutions 1e-8 against the scipy oracle
K (K^T A K)^-1 K^T b (tests/conftest.py:42-45) and 1e-10 against the JAX
package.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.utils import gather_transformation_matrix as jx_K
from dolfinx_mpc_tpu.utils import mpc_utils as ju
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs, gather_transformation_matrix
from dolfinx_mpc_tpu_torch.utils import mpc_utils as pu

PKGS = {"jx": (jx, jf, jm, ju), "pt": (pt, pf, pm, pu)}


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


def _vec(pkg, c, *vals):
    """A constant vector inside an integrand, of the quadrature point's
    dtype (and device): numpy constants cannot meet vmapped tensors."""
    import jax.numpy as jnp

    return {"jx": jnp.stack, "pt": torch.stack}[pkg]([v + 0.0 * c.x[0] for v in vals])


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rtol=1e-12):
    """Sparse or dense, relative to the reference's largest entry."""
    scale = max(abs(ref).max(), 1e-300)
    return abs(got - ref).max() <= rtol * scale


def _oracle(pkg, a, L, mpc, bcs):
    """K (K^H A K)^-1 K^H b with the package's unconstrained assembly."""
    mod = PKGS[pkg][0]
    A = mod.assemble_matrix(a, None, bcs=bcs, **_kw(pkg)).to_scipy()
    b = mod.assemble_vector(L, None, **_kw(pkg))
    b = _np(mod.set_bc(mod.apply_lifting(b, [a], [bcs], None), bcs))
    K = (gather_transformation_matrix if pkg == "pt" else jx_K)(mpc)
    return K @ spla.spsolve((K.T.conj() @ A @ K).tocsc(), K.T.conj() @ b)


def test_mixed_dofmap_layout():
    out = {}
    for pkg in PKGS:
        mod, _, M, _ = PKGS[pkg]
        mesh = M.create_unit_square(3, 3)
        W = mod.mixed_functionspace(mesh, [("Lagrange", 2, (2,)), ("Lagrange", 1)])
        V, Q = W.spaces
        assert W.num_dofs == V.num_dofs + Q.num_dofs
        assert W.dofmap.shape == (mesh.num_cells, 2 * 6 + 3)
        assert W.dofmap[:, :12].max() < V.num_dofs and W.dofmap[:, 12:].min() >= V.num_dofs
        assert W.sub(1).dof_offset == V.num_dofs and W.sub(0).dof_offset == 0
        assert W.sub(1).mixed_parent is W
        out[pkg] = (W.dofmap, W.dof_coords_blocks, W.offsets)
    for got, ref in zip(out["pt"], out["jx"]):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


def test_mixed_bc_on_subspace():
    """Dirichlet on a field view lands in the mixed numbering, with vector
    constants and Function values; equal to the JAX package's."""
    out = {}
    for pkg in PKGS:
        mod, _, M, _ = PKGS[pkg]
        W = mod.mixed_functionspace(M.create_unit_square(3, 3), [("Lagrange", 1, (2,)), ("Lagrange", 1)])
        Wv, Wq = W.sub(0), W.sub(1)
        dofs = mod.locate_dofs_geometrical(Wv, lambda x: np.isclose(x[0], 0.0))
        bc = mod.dirichletbc(np.array([1.5, -2.0]), dofs, Wv)
        g = mod.Function(Wv, **_kw(pkg))
        g.interpolate(lambda x: np.stack([x[0] + 1.0, x[1]]))
        bc2 = mod.dirichletbc(g, dofs)
        bcq = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(Wq, lambda x: np.isclose(x[1], 0.0)), Wq)
        assert bc.dofs.max() < W.spaces[0].num_dofs and bcq.dofs.min() >= W.spaces[0].num_dofs
        assert set(np.unique(bc.dof_values())) == {1.5, -2.0}
        assert np.allclose(bc2.dof_values()[::2], 1.0)
        out[pkg] = [(b.dofs, b.dof_values()) for b in (bc, bc2, bcq)]
    for (dg, vg), (dr, vr) in zip(out["pt"], out["jx"]):
        assert np.array_equal(dg, dr) and np.array_equal(vg, vr)


def _periodic_mixed(pkg):
    mod, F, M, _ = PKGS[pkg]
    W = mod.mixed_functionspace(M.create_unit_square(4, 4), [("Lagrange", 2, (2,)), ("Lagrange", 1)])
    Wv = W.sub(0)
    bdofs = mod.locate_dofs_geometrical(Wv, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0))
    bc = mod.dirichletbc(np.array([0.0, 0.0]), bdofs, Wv)
    mpc = mod.MultiPointConstraint(W, **_kw(pkg))
    mpc.create_periodic_constraint_geometrical(
        Wv, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    a = mod.BilinearForm(W, lambda u, v, c: F.inner(F.grad(u[0]), F.grad(v[0])) + F.inner(u[0], v[0])
                         + F.inner(u[1], v[1]))
    L = mod.LinearForm(W, lambda v, c: F.inner(_vec(pkg, c, 1.0, 0.5), v[0]) + v[1].value)
    return W, mpc, a, L, bc


def test_mixed_periodic_on_subspace():
    """Periodic MPC on the velocity field of a mixed space: the constraint
    tables equal the JAX package's, the K^H A K check holds, and the
    constrained solve matches the oracle and the JAX package."""
    res = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        W, mpc, a, L, bc = _periodic_mixed(pkg)
        assert mpc.num_local_slaves > 0 and np.asarray(mpc.slaves).max() < W.spaces[0].num_dofs
        A_mpc = mod.assemble_matrix(a, mpc, bcs=[bc], **_kw(pkg)).to_scipy()
        b_mpc = _np(mod.set_bc(mod.assemble_vector(L, mpc, **_kw(pkg)), [bc]))
        x = spla.spsolve(A_mpc.tocsc(), b_mpc)
        if pkg == "pt":
            compare_mpc_lhs(pt.assemble_matrix(a, None, bcs=[bc], device="cpu").to_scipy(), A_mpc, mpc)
            x = mpc.finalized.backsubstitution(torch.as_tensor(x)).numpy()
        else:
            import jax.numpy as jnp

            x = np.asarray(mpc.finalized.backsubstitution(jnp.asarray(x)))
        assert np.abs(x - _oracle(pkg, a, L, mpc, [bc])).max() < 1e-8
        res[pkg] = (mpc.slaves, A_mpc, x)
    assert np.array_equal(res["pt"][0], np.asarray(res["jx"][0]))
    assert _close(res["pt"][1], res["jx"][1])
    assert np.abs(res["pt"][2] - res["jx"][2]).max() <= 1e-10


def _stokes_mixed(pkg, nx=8, ny=4, theta=np.pi / 7):
    """demo_stokes's single-matrix system at (nx, ny)."""
    mod, F, M, U = PKGS[pkg]
    mesh = M.create_rectangle((0, 0), (2.0, 1.0), (nx, ny))
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mesh.points[:] = mesh.points @ R.T
    W = mod.mixed_functionspace(mesh, [("Lagrange", 2, (2,)), ("Lagrange", 1)])
    Wv = W.sub(0)
    in_rot = lambda m: (lambda x: m(R.T @ x[:2]))  # noqa: E731
    wall = M.locate_entities_boundary(mesh, 1, in_rot(lambda X: np.isclose(X[1], 0.0) | np.isclose(X[1], 1.0)))
    mt = M.meshtags(mesh, 1, wall, 1)
    g = mod.Function(Wv, **_kw(pkg))

    def inflow(x):
        X = np.linalg.inv(R) @ x[:2]
        return R @ np.stack([4.0 * X[1] * (1.0 - X[1]), np.zeros_like(X[1])])

    g.interpolate(inflow)
    bc = mod.dirichletbc(g, mod.locate_dofs_geometrical(Wv, in_rot(lambda X: np.isclose(X[0], 0.0))))
    nh = U.create_normal_approximation(Wv, mt, 1, **_kw(pkg))
    mpc = mod.MultiPointConstraint(W, **_kw(pkg))
    mpc.create_slip_constraint(Wv, (mt, 1), nh, [bc])
    mpc.finalize()
    a = mod.BilinearForm(W, lambda u, v, c: F.inner(F.grad(u[0]), F.grad(v[0])) - F.div(v[0]) * F.conj(u[1].value)
                         - F.div(u[0]) * F.conj(v[1].value))
    L = mod.LinearForm(W, lambda v, c: F.inner(c.x * 0.0, v[0]) + 0.0 * v[1].value)
    return mod, W, Wv, mpc, a, L, bc, nh, wall


def test_mixed_stokes_single_matrix():
    """Rotated-channel Taylor-Hood Stokes in ONE matrix with a slip MPC on
    the velocity field: slaves and the constrained matrix equal the JAX
    package's, the solve matches the oracle and slip holds."""
    res = {}
    for pkg in PKGS:
        mod, W, Wv, mpc, a, L, bc, nh, wall = _stokes_mixed(pkg)
        A_mpc = mod.assemble_matrix(a, mpc, bcs=[bc], **_kw(pkg)).to_scipy()
        b = mod.assemble_vector(L, mpc, **_kw(pkg))
        b = _np(mod.set_bc(mod.apply_lifting(b, [a], [[bc]], mpc), [bc]))
        x = spla.spsolve(A_mpc.tocsc(), b)
        if pkg == "pt":
            compare_mpc_lhs(pt.assemble_matrix(a, None, bcs=[bc], device="cpu").to_scipy(), A_mpc, mpc)
            x = mpc.finalized.backsubstitution(torch.as_tensor(x)).numpy()
            u, p = pt.split(pt.Function(W, x, device="cpu"))
            assert u.x.array.data_ptr() != p.x.array.data_ptr()
            uv = u.x.array.numpy().reshape(-1, 2)
            nvals = nh.x.array.numpy().reshape(-1, 2)
            wb = pt.locate_dofs_topological(Wv, 1, wall)
            assert np.abs((uv[wb] * nvals[wb]).sum(1)).max() < 1e-9
        else:
            import jax.numpy as jnp

            x = np.asarray(mpc.finalized.backsubstitution(jnp.asarray(x)))
        assert np.abs(x - _oracle(pkg, a, L, mpc, [bc])).max() < 1e-8
        res[pkg] = (mpc.slaves, A_mpc, b, x)
    assert np.array_equal(res["pt"][0], np.asarray(res["jx"][0]))
    assert _close(res["pt"][1], res["jx"][1]) and _close(res["pt"][2], res["jx"][2])
    assert np.abs(res["pt"][3] - res["jx"][3]).max() <= 1e-10


def test_mixed_coefficient():
    """A coefficient on a mixed space feeds the kernel as a tuple of
    per-field Args: the pressure field of w times v equals the same
    integral with the pressure standalone, and the JAX package's vector."""
    out = {}
    for pkg in PKGS:
        mod, _, M, _ = PKGS[pkg]
        mesh = M.create_unit_square(3, 3)
        W = mod.mixed_functionspace(mesh, [("Lagrange", 1, (2,)), ("Lagrange", 1)])
        w = mod.Function(W, np.random.default_rng(3).standard_normal(W.num_dofs), **_kw(pkg))
        V1 = mod.functionspace(mesh, ("Lagrange", 1))
        b = _np(mod.assemble_vector(mod.LinearForm(V1, lambda v, c: c["w"][1].value * v.value,
                                                   coefficients={"w": w}), None, **_kw(pkg)))
        _, p = mod.split(w)
        pq = mod.Function(V1, _np(p.x.array), **_kw(pkg))
        b2 = _np(mod.assemble_vector(mod.LinearForm(V1, lambda v, c: c["p"].value * v.value,
                                                    coefficients={"p": pq}), None, **_kw(pkg)))
        assert np.abs(b - b2).max() < 1e-13
        out[pkg] = b
    assert _close(out["pt"], out["jx"])


def test_split_views_the_mixed_function():
    """split() returns views: writing a field writes the mixed vector."""
    W = pt.mixed_functionspace(pm.create_unit_square(2, 2), [("Lagrange", 1, (2,)), ("Lagrange", 1)])
    w = pt.Function(W, device="cpu")
    u, p = pt.split(w)
    p.x.array[:] = 3.0
    assert torch.all(w.x.array[W.field_slice(1)] == 3.0) and torch.all(w.x.array[W.field_slice(0)] == 0.0)


def test_bc_value_function_space_placements():
    """DirichletBC.dof_values for a Function value on the offset field view,
    on the collapsed base space and on the whole mixed parent."""
    W = pt.mixed_functionspace(pm.create_unit_square(3, 3), [("Lagrange", 1), ("Lagrange", 1)])
    Wq = W.sub(1)
    qb = pt.locate_dofs_geometrical(Wq, lambda x: np.isclose(x[1], 0.0))
    for space, vals in ((Wq, 100.0 + np.arange(Wq.num_dofs)), (W.spaces[1], 100.0 + np.arange(Wq.num_dofs)),
                        (W, 100.0 + np.arange(W.num_dofs))):
        g = pt.Function(space, vals, device="cpu")
        bc = pt.dirichletbc(g, qb, Wq)
        expect = 100.0 + (bc.dofs if space is W else bc.dofs - Wq.dof_offset)
        assert np.allclose(bc.dof_values(), expect)


def _periodic_xz(x):
    return np.isclose(x[0], 1.0) | np.isclose(x[2], 1.0)


def _map_xz(x):
    out = np.array(x, copy=True)
    out[0] = np.where(np.isclose(x[0], 1.0), x[0] - 1.0, x[0])
    out[2] = np.where(np.isclose(x[2], 1.0), x[2] - 1.0, x[2])
    return out


@pytest.mark.parametrize("cell_type", ["tetrahedron", "hexahedron"])
@pytest.mark.parametrize("order,els", [(2, 4), (3, 2)])
def test_stokes_channelflow(cell_type, order, els):
    """Poiseuille flow with periodic MPCs in x and z on nest blocks: the
    nest matrix equals the JAX package's, the solve reproduces
    u_x = y (1 - y) / 2 to 1e-8, and the velocity block equals K^T A K."""
    res = {}
    for pkg in PKGS:
        mod, F, M, _ = PKGS[pkg]
        mesh = M.create_unit_cube(els, els, els, cell_type=cell_type)
        V = mod.functionspace(mesh, ("Lagrange", order, (3,)))
        Q = mod.functionspace(mesh, ("Lagrange", order - 1))
        bc = mod.dirichletbc(np.zeros(3), mod.locate_dofs_geometrical(
            V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
        mpc_u = mod.MultiPointConstraint(V, **_kw(pkg))
        mpc_u.create_periodic_constraint_geometrical(V, _periodic_xz, _map_xz, [bc])
        mpc_u.finalize()
        mpc_p = mod.MultiPointConstraint(Q, **_kw(pkg))
        mpc_p.create_periodic_constraint_geometrical(Q, _periodic_xz, _map_xz, [])
        mpc_p.finalize()
        a00 = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)))
        a01 = mod.BilinearForm(V, lambda p, v, c: -F.div(v) * F.conj(p.value), V_trial=Q)
        a10 = mod.BilinearForm(Q, lambda u, q, c: -F.div(u) * F.conj(q.value), V_trial=V)
        a_nest = [[a00, a01], [a10, None]]
        A = mod.create_matrix_nest(a_nest, [mpc_u, mpc_p])
        mod.assemble_matrix_nest(A, a_nest, [mpc_u, mpc_p], bcs=[bc])
        S = A.to_scipy()
        L0 = mod.LinearForm(V, lambda v, c: F.inner(_vec(pkg, c, 1.0, 0.0, 0.0), v))
        L1 = mod.LinearForm(Q, lambda q, c: 0.0 * q.value)
        b = mod.create_vector_nest([L0, L1], [mpc_u, mpc_p])
        mod.assemble_vector_nest(b, [L0, L1], [mpc_u, mpc_p])
        b0 = mod.set_bc(mod.apply_lifting(b.parts[0], [a00], [[bc]], mpc_u), [bc])
        rhs = np.concatenate([_np(b0), _np(b.parts[1])])
        res[pkg] = (S, rhs)
        if pkg == "jx":
            continue
        # pin one non-slave pressure dof and the pressure-slave rows (the
        # None (1, 1) block has no slave diagval), solve, backsubstitute
        nV = V.num_dofs
        Sl = S.tolil()
        pins = [nV + int(np.setdiff1d(np.arange(Q.num_dofs), mpc_p.slaves)[0])]
        pins += [nV + int(s) for s in mpc_p.slaves]
        for pin in pins:
            Sl.rows[pin], Sl.data[pin] = [pin], [1.0]
            rhs[pin] = 0.0
        x = torch.as_tensor(spla.spsolve(Sl.tocsr(), rhs))
        u = mpc_u.finalized.backsubstitution(x[:nV]).numpy().reshape(-1, 3)
        p = mpc_p.finalized.backsubstitution(x[nV:]).numpy()
        xd = V.tabulate_dof_coordinates()
        if xd.shape[0] == V.num_dofs:
            xd = xd[::3]
        ue = np.zeros_like(u)
        ue[:, 0] = 0.5 * xd[:, 1] * (1.0 - xd[:, 1])
        assert np.abs(u - ue).max() < 1e-8 and np.abs(u[:, 0]).max() > 0.1 and np.isfinite(p).all()
        A_org = pt.assemble_matrix(a00, None, bcs=[bc], device="cpu").to_scipy()
        A_mpc = pt.assemble_matrix(a00, mpc_u, bcs=[bc], device="cpu").to_scipy()
        K = gather_transformation_matrix(mpc_u)
        keep = np.setdiff1d(np.arange(nV), mpc_u.slaves)
        diff = (K.T @ A_org @ K).tocsr() - A_mpc[keep][:, keep]
        assert (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-9
    assert _close(res["pt"][0], res["jx"][0]) and _close(res["pt"][1], res["jx"][1])


def _two_mpcs(mod, V, Q, pkg):
    mpc_v = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc_v.create_general_constraint(
        {np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 0.0]).tobytes(): 0.2}}, subspace_slave=0, subspace_master=0)
    mpc_v.finalize()
    mpc_q = mod.MultiPointConstraint(Q, **_kw(pkg))
    mpc_q.create_general_constraint({np.array([0.0, 1.0]).tobytes(): {np.array([1.0, 0.0]).tobytes(): 0.3}})
    mpc_q.finalize()
    return mpc_v, mpc_q


def test_rectangular_assembly():
    """b(v, q) = div(v) q with a row MPC on V and a column MPC on Q: equal
    to K_V^H B K_Q and to the JAX package's matrix."""
    res = {}
    for pkg in PKGS:
        mod, F, M, _ = PKGS[pkg]
        mesh = M.create_unit_square(4, 4)
        V = mod.functionspace(mesh, ("Lagrange", 2, (2,)))
        Q = mod.functionspace(mesh, ("Lagrange", 1))
        mpc_v, mpc_q = _two_mpcs(mod, V, Q, pkg)
        bf = mod.BilinearForm(V, lambda p, v, c: F.div(v) * F.conj(p.value), V_trial=Q)
        B_org = mod.assemble_matrix(bf, None, dtype=np.float64, **_kw(pkg)).to_scipy()
        B_mpc = mod.assemble_matrix(bf, (mpc_v, mpc_q), **_kw(pkg)).to_scipy()
        assert B_mpc.shape == (V.num_dofs, Q.num_dofs)
        if pkg == "pt":
            Kv, Kq = gather_transformation_matrix(mpc_v), gather_transformation_matrix(mpc_q)
            ref = (Kv.T.conj() @ B_org @ Kq).tocsr()
            keep_r = np.setdiff1d(np.arange(V.num_dofs), mpc_v.slaves)
            keep_c = np.setdiff1d(np.arange(Q.num_dofs), mpc_q.slaves)
            diff = ref - B_mpc[keep_r][:, keep_c]
            assert (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-9
        res[pkg] = B_mpc
    assert np.array_equal(res["pt"].indices, res["jx"].indices) and _close(res["pt"], res["jx"])


def test_nest_stokes_like():
    """A 2 x 2 saddle-point nest with per-space MPCs: its matvec equals the
    scipy bmat product and the JAX package's nest matvec; the nest vector
    equals the JAX package's; the BELL nest (to_bell) gives the same
    product."""
    res = {}
    x = None
    for pkg in PKGS:
        mod, F, M, _ = PKGS[pkg]
        mesh = M.create_unit_square(3, 3)
        V = mod.functionspace(mesh, ("Lagrange", 2, (2,)))
        Q = mod.functionspace(mesh, ("Lagrange", 1))
        mpc_v, mpc_q = _two_mpcs(mod, V, Q, pkg)
        a00 = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)))
        a01 = mod.BilinearForm(V, lambda p, v, c: -F.div(v) * F.conj(p.value), V_trial=Q)
        a10 = mod.BilinearForm(Q, lambda u, q, c: -F.div(u) * F.conj(q.value), V_trial=V)
        a_nest = [[a00, a01], [a10, None]]
        A = mod.create_matrix_nest(a_nest, [mpc_v, mpc_q])
        mod.assemble_matrix_nest(A, a_nest, [mpc_v, mpc_q])
        S = A.to_scipy()
        if x is None:
            x = np.random.default_rng(0).standard_normal(S.shape[1])
        if pkg == "pt":
            y = A.matvec(torch.as_tensor(x)).numpy()
            Ab = A.to_bell()
            for B in (Ab.blocks[0][0], Ab.blocks[0][1], Ab.blocks[1][0]):
                B.pack()  # the packed layout K8 reads (made at construction on the card)
            assert np.abs(Ab.matvec(torch.as_tensor(x)).numpy() - S @ x).max() < 1e-12 * np.abs(S @ x).max()
            assert torch.equal(Ab.diagonal(), A.diagonal())
        else:
            import jax.numpy as jnp

            y = np.asarray(A.matvec(jnp.asarray(x)))
        assert np.abs(y - S @ x).max() < 1e-10
        L = [mod.LinearForm(V, lambda v, c: F.inner(_vec(pkg, c, 1.0, 1.0), v)),
             mod.LinearForm(Q, lambda q, c: 0.0 * q.value)]
        b = mod.create_vector_nest(L, [mpc_v, mpc_q])
        mod.assemble_vector_nest(b, L, [mpc_v, mpc_q])
        res[pkg] = (S, y, _np(b.array), _np(A.diagonal()))
    for got, ref in zip(res["pt"], res["jx"]):
        assert got.shape == ref.shape and _close(got, ref)


def test_nest_block_preconditioner():
    """block_diag_preconditioner applies each part to its block's slice."""
    from dolfinx_mpc_tpu.ops.nest import block_diag_preconditioner as jx_bd
    from dolfinx_mpc_tpu_torch.ops.nest import block_diag_preconditioner as pt_bd

    r = np.random.default_rng(4).standard_normal(7)
    got = pt_bd([lambda s: 2.0 * s, lambda s: -s], [3, 4])(torch.as_tensor(r)).numpy()
    import jax.numpy as jnp

    ref = np.asarray(jx_bd([lambda s: 2.0 * s, lambda s: -s], [3, 4])(jnp.asarray(r)))
    assert np.array_equal(got, ref)
