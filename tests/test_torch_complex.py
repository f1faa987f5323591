"""Complex scalars through the port against the JAX package on the CPU.

- The complex128 cases of the JAX package's scalar_dtype tests (its real
  cases are mirrored elsewhere): tests/test_contact.py,
  test_integration_domains.py, test_lifting.py, test_matrix_assembly.py,
  test_mpc_pipeline.py, test_rectangular_and_nest.py,
  test_slip_and_periodic.py, test_surface_integral.py and
  test_vector_poisson.py, each case through both packages on the same
  inputs: the JAX test's own oracle holds in both, and the port's values
  equal the JAX package's to 1e-12 relative.
- A Bloch phase (coefficient e^{i pi/3}): the lattice side blocks, which
  need conj(K_e)^H A_e K_e, against the JAX package's on "csr" and
  "cells"; the refusal of "fold"; LinearProblem's route.
- The Hermitian coarse inverse of LatticeGMG on a Bloch-phase coarse level
  (the JAX package keeps the real part only: ROADMAP queue 3), and GMG-CG.
- The Krylov solvers and the eigensolver on complex Hermitian systems
  against the JAX package: the same counts, solutions to 1e-10.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu import constraints as jc
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu.utils import compare_mpc_lhs as jx_lhs, compare_mpc_rhs as jx_rhs
from dolfinx_mpc_tpu.utils import gather_transformation_matrix as jx_K
from dolfinx_mpc_tpu.utils import mpc_utils as ju
from dolfinx_mpc_tpu_torch import constraints as pc
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs, compare_mpc_rhs, gather_transformation_matrix
from dolfinx_mpc_tpu_torch.utils import mpc_utils as pu

import test_torch_surface_integral as surface

C128 = np.complex128
PKGS = {"jx": (jx, jf, jm, ju, jc), "pt": (pt, pf, pm, pu, pc)}
BLOCH = np.exp(1j * np.pi / 3)
dtype_c128 = pytest.mark.parametrize("dtype", [C128], ids=["complex"])


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, ref):
    return abs(got - ref).max() / max(abs(ref).max(), 1e-300)


def _stack(pkg, c, *vals):
    """A vector inside an integrand, of the quadrature point's dtype."""
    return {"jx": jnp.stack, "pt": torch.stack}[pkg]([v + 0.0 * c.x[0] for v in vals])


def _mpc(pkg, V, dtype=C128):
    return PKGS[pkg][0].MultiPointConstraint(V, dtype, **_kw(pkg))


def _lhs_case(build, dtype, tol=1e-12):
    """build(pkg, dtype) -> (a, mpc, bcs): the unconstrained and constrained
    matrices of each package meet the K^H A K oracle, are complex, and the
    port's equal the JAX package's."""
    out = {}
    for pkg, check in (("jx", jx_lhs), ("pt", compare_mpc_lhs)):
        mod = PKGS[pkg][0]
        a, mpc, bcs = build(pkg, dtype)
        A_org = mod.assemble_matrix(a, None, bcs=bcs, dtype=dtype, **_kw(pkg)).to_scipy()
        A_mpc = mod.assemble_matrix(a, mpc, bcs=bcs, dtype=dtype).to_scipy()
        check(A_org, A_mpc, mpc)
        assert A_mpc.dtype == np.dtype(dtype)
        out[pkg] = A_mpc
    assert _rel(out["pt"], out["jx"]) <= tol


def _rhs_case(build, dtype, tol=1e-12):
    """build(pkg, dtype) -> (L, mpc): K^H b in both packages against the
    oracle, the port's equal to the JAX package's."""
    out = {}
    for pkg, check in (("jx", jx_rhs), ("pt", compare_mpc_rhs)):
        mod = PKGS[pkg][0]
        L, mpc = build(pkg, dtype)
        b_org = _np(mod.assemble_vector(L, None, dtype=dtype, **_kw(pkg)))
        b_mpc = _np(mod.assemble_vector(L, mpc, dtype=dtype))
        check(b_org, b_mpc, mpc)
        out[pkg] = b_mpc
    assert b_mpc.dtype == np.dtype(dtype) and _rel(out["pt"], out["jx"]) <= tol


def _elast(F):
    return lambda u, v, c: 2 * F.inner(F.sym(F.grad(u)), F.sym(F.grad(v))) + 1.25 * F.div(u) * F.conj(F.div(v))


# ---------------------------------------------------------------------------
# tests/test_contact.py
# ---------------------------------------------------------------------------


def _stacked_squares(M, n_bot=4, n_top=3):
    bot = M.create_rectangle((0.0, 0.0), (1.0, 1.0), (n_bot, n_bot))
    top = M.create_rectangle((0.0, 1.0), (1.0, 2.0), (n_top, n_top))
    return M.Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                  bot.cell_type)


def _interface_tags(M, mesh, axis=1):
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts], 1.0)[:, :, axis].all(axis=1)
    iface = np.flatnonzero(on_iface & np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets()))
    cent = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, axis]
    return M.meshtags(mesh, mesh.tdim - 1, iface, np.where(cent > 1.0, 1, 2))


def _contact_inelastic(pkg, dtype):
    mod, F, M, U, _ = PKGS[pkg]
    mesh = _stacked_squares(M)
    V = mod.functionspace(mesh, ("Lagrange", 1, (2,)))
    mpc = _mpc(pkg, V, dtype)
    mpc.create_contact_inelastic_condition(_interface_tags(M, mesh), 1, 2)
    mpc.finalize()
    assert mpc.num_local_slaves == 8
    return mod.BilinearForm(V, _elast(F)), mpc, None


def _contact_slip(pkg, dtype):
    mod, F, M, U, _ = PKGS[pkg]
    mesh = _stacked_squares(M)
    V = mod.functionspace(mesh, ("Lagrange", 1, (2,)))
    mt = _interface_tags(M, mesh)
    nh = U.create_normal_approximation(V, mt, 1, **_kw(pkg))
    mpc = _mpc(pkg, V, dtype)
    mpc.create_contact_slip_condition(mt, 1, 2, nh)
    mpc.finalize()
    assert mpc.num_local_slaves == 4
    return mod.BilinearForm(V, _elast(F)), mpc, None


def _point_to_point(pkg, dtype):
    mod, F, M, U, C = PKGS[pkg]
    V = mod.functionspace(_stacked_squares(M, 3, 3), ("Lagrange", 1, (2,)))
    data = C.create_point_to_point_constraint(V, np.array([1.0, 2.0]), np.array([0.0, 0.0]), dtype=dtype)
    mpc = _mpc(pkg, V, dtype)
    mpc.add_constraint_from_mpc_data(V, data)
    mpc.finalize()
    assert mpc.num_local_slaves == 2
    return mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v))), mpc, None


def _contact_slip_rotated(pkg, dtype):
    mod, F, M, U, _ = PKGS[pkg]
    bot = M.create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (3, 3, 3))
    top = M.create_box((0.0, 0.0, 1.0), (1.0, 1.0, 2.0), (2, 2, 2))
    mesh = M.Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                  bot.cell_type)
    mt = _interface_tags(M, mesh, axis=2)
    mesh.points[:] = mesh.points @ U.rotation_matrix([1.0, 1.0, 0.0], 0.3).T
    V = mod.functionspace(mesh, ("Lagrange", 1, (3,)))
    nh = U.create_normal_approximation(V, mt, 1, **_kw(pkg))
    mpc = _mpc(pkg, V, dtype)
    mpc.create_contact_slip_condition(mt, 1, 2, nh)
    mpc.finalize()
    assert mpc.num_local_slaves == 9
    return mod.BilinearForm(V, _elast(F)), mpc, None


@dtype_c128
@pytest.mark.parametrize("build", [_contact_inelastic, _contact_slip, _point_to_point, _contact_slip_rotated],
                         ids=["contact_inelastic", "contact_slip", "point_to_point", "contact_slip_rotated"])
def test_contact_complex(build, dtype):
    """tests/test_contact.py's four scalar_dtype tests at complex128."""
    _lhs_case(build, dtype)


# ---------------------------------------------------------------------------
# tests/test_integration_domains.py, test_lifting.py
# ---------------------------------------------------------------------------


def _cell_subdomains(pkg, dtype):
    mod, F, M, _, _ = PKGS[pkg]
    mesh = M.create_unit_square(4, 4)
    V = mod.functionspace(mesh, ("Lagrange", 1))
    left = M.locate_entities(mesh, mesh.tdim, lambda x: x[0] <= 0.5 + 1e-12)
    right = np.setdiff1d(np.arange(mesh.num_cells), left)
    a = mod.BilinearForm(V, lambda u, v, c: 2.0 * F.inner(F.grad(u), F.grad(v)), entities=left) + mod.BilinearForm(
        V, lambda u, v, c: 5.0 * F.inner(u, v), entities=right)
    mpc = _mpc(pkg, V, dtype)
    mpc.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {np.array([0.25, 1.0]).tobytes(): 0.5,
                                                                    np.array([0.0, 1.0]).tobytes(): 0.5}})
    mpc.finalize()
    return a, mpc, None


@dtype_c128
def test_cell_subdomains_complex(dtype):
    """tests/test_integration_domains.py::test_cell_subdomains at complex128."""
    _lhs_case(_cell_subdomains, dtype)


def _lifted(pkg, dtype, cube, degree):
    """tests/test_lifting.py's _check_lifting in package `pkg`: K^H (b - A g)
    with inhomogeneous Dirichlet values against the package's oracle;
    returns the lifted vector."""
    mod, F, M, _, _ = PKGS[pkg]
    mesh = M.create_unit_cube(2, 2, 2) if cube else M.create_unit_square(6, 6)
    V = mod.functionspace(mesh, ("Lagrange", degree))
    bc = mod.dirichletbc(2.3, mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 0.0)), V)
    mpc = _mpc(pkg, V, dtype)
    mpc.create_general_constraint({np.array([1.0, 0.5, 0.5][: mesh.gdim]).tobytes():
                                   {np.array([0.5, 0.5, 0.5][: mesh.gdim]).tobytes(): 0.7}})
    mpc.finalize()
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))
    L = mod.LinearForm(V, lambda v, c: (1.0 + c.x[0]) * v.value)
    b = mod.assemble_vector(L, mpc, dtype=dtype)
    b = _np(mod.set_bc(mod.apply_lifting(b, [a], [[bc]], mpc, dtype=dtype), [bc]))
    A_org = mod.assemble_matrix(a, None, dtype=dtype, **_kw(pkg)).to_scipy()
    b_org = _np(mod.assemble_vector(L, None, dtype=dtype, **_kw(pkg)))
    g = np.zeros(V.num_dofs, dtype=dtype)
    g[bc.dofs] = bc.dof_values(dtype)
    K = (gather_transformation_matrix if pkg == "pt" else jx_K)(mpc)
    ref = np.zeros(V.num_dofs, dtype=dtype)
    free = np.ones(V.num_dofs, bool)
    free[np.asarray(mpc.slaves)] = False
    ref[free] = np.asarray(K.conj().T @ (b_org - A_org @ g)).ravel()
    ref[bc.dofs] = g[bc.dofs]
    assert b.dtype == np.dtype(dtype) and np.abs(b - ref).max() < 1e-10
    return b


@dtype_c128
@pytest.mark.parametrize("cube,degree", [(False, 1), (True, 2)], ids=["lifting_2d", "lifting_3d_p2"])
def test_lifting_complex(cube, degree, dtype):
    """tests/test_lifting.py's two tests at complex128."""
    assert _rel(_lifted("pt", dtype, cube, degree), _lifted("jx", dtype, cube, degree)) <= 1e-12


# ---------------------------------------------------------------------------
# tests/test_matrix_assembly.py
# ---------------------------------------------------------------------------


def _poisson(pkg, V):
    mod, F, _, _, _ = PKGS[pkg]
    return (mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v))),
            mod.LinearForm(V, lambda v, c: (c.x[0] + 2.0) * np.conj(1.0) * v.value))


def _dict_mpc(pkg, V, dtype):
    mpc = _mpc(pkg, V, dtype)
    mpc.create_general_constraint({
        np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 0.0]).tobytes(): 0.43, np.array([1.0, 0.0]).tobytes(): 0.11},
        np.array([0.0, 1.0]).tobytes(): {np.array([1.0, 0.0]).tobytes(): 0.57}})
    mpc.finalize()
    return mpc


@functools.lru_cache(maxsize=None)
def _square_space(pkg, cell_type, degree):
    mod, _, M, _, _ = PKGS[pkg]
    return mod.functionspace(M.create_unit_square(4, 4, cell_type), ("Lagrange", degree))


@dtype_c128
@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("degree", [1, 2])
def test_matrix_assembly_vs_oracle_complex(cell_type, degree, dtype):
    """tests/test_matrix_assembly.py::test_matrix_assembly_vs_oracle at
    complex128: matrix and vector."""
    def build(pkg, dt):
        V = _square_space(pkg, cell_type, degree)
        return _poisson(pkg, V)[0], _dict_mpc(pkg, V, dt), None

    def build_rhs(pkg, dt):
        V = _square_space(pkg, cell_type, degree)
        return _poisson(pkg, V)[1], _dict_mpc(pkg, V, dt)

    _lhs_case(build, dtype)
    _rhs_case(build_rhs, dtype)


def _slave_master_same_cell(pkg, dtype):
    mod, F, M, _, _ = PKGS[pkg]
    V = mod.functionspace(M.create_unit_square(1, 1), ("Lagrange", 1))
    mpc = _mpc(pkg, V, dtype)
    mpc.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {np.array([1.0, 0.0]).tobytes(): 0.3,
                                                                    np.array([0.0, 1.0]).tobytes(): 0.7}})
    mpc.finalize()
    return _poisson(pkg, V)[0], mpc, None


@dtype_c128
def test_slave_master_same_cell_complex(dtype):
    """tests/test_matrix_assembly.py::test_slave_master_same_cell at complex128."""
    _lhs_case(_slave_master_same_cell, dtype)


@dtype_c128
@pytest.mark.parametrize("cell_type", ["tetrahedron", "hexahedron"])
def test_matrix_assembly_3d_complex(cell_type, dtype):
    """tests/test_matrix_assembly.py::test_matrix_assembly_3d at complex128."""
    def build(pkg, dt):
        mod, F, M, _, _ = PKGS[pkg]
        V = mod.functionspace(M.create_unit_cube(2, 2, 2, cell_type), ("Lagrange", 1))
        a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))
        mpc = _mpc(pkg, V, dt)
        mpc.create_general_constraint({np.array([1.0, 1.0, 1.0]).tobytes(): {
            np.array([0.0, 0.0, 0.0]).tobytes(): 0.5, np.array([1.0, 0.0, 0.0]).tobytes(): 0.25}})
        mpc.finalize()
        return a, mpc, None

    _lhs_case(build, dtype)


# ---------------------------------------------------------------------------
# tests/test_mpc_pipeline.py
# ---------------------------------------------------------------------------


def _pipeline(pkg, dtype, cell_type, degree, n, marker, g, mpc_data, mass, source):
    """tests/test_mpc_pipeline.py's problem in package `pkg`: (a, L, mpc, bc)."""
    mod, F, M, _, _ = PKGS[pkg]
    V = mod.functionspace(M.create_unit_square(n, n, cell_type), ("Lagrange", degree))
    bc = mod.dirichletbc(g, mod.locate_dofs_geometrical(V, marker), V)
    mpc = _mpc(pkg, V, dtype)
    mpc.create_general_constraint(mpc_data)
    mpc.finalize()
    a = mod.BilinearForm(V, (lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v)) if mass
                         else (lambda u, v, c: F.inner(F.grad(u), F.grad(v))))
    return a, mod.LinearForm(V, source), mpc, bc


def _check_pipeline(dtype, **kw):
    """The port's LinearProblem solution against K (K^H A K)^-1 K^H b with
    A, b and K of the JAX package (1e-8, the JAX test's gate; the JAX test
    holds the JAX package's own solution to it)."""
    a, L, mpc, bc = _pipeline("pt", dtype, **kw)
    u = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-13}).solve().x.array.numpy()
    aj, Lj, mj, bcj = _pipeline("jx", dtype, **kw)
    A = jx.assemble_matrix(aj, None, bcs=[bcj]).to_scipy()
    b = np.asarray(jx.set_bc(jx.apply_lifting(jx.assemble_vector(Lj, None), [aj], [[bcj]], None), [bcj]))
    K = jx_K(mj)
    u_ref = K @ spla.spsolve((K.T.conj() @ A @ K).tocsr(), K.T.conj() @ b)
    assert u.dtype == np.dtype(dtype) and np.abs(u - u_ref).max() < 1e-8
    if kw["g"]:
        assert np.isclose(u[bc.dofs], kw["g"]).all()


@dtype_c128
@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
def test_pipeline_complex(cell_type, dtype):
    """tests/test_mpc_pipeline.py::test_pipeline at complex128 (the port's
    LinearProblem takes the lattice "cells" format on the unit square)."""
    _check_pipeline(dtype, cell_type=cell_type, degree=1, n=5, marker=lambda x: np.isclose(x[1], 0.0), g=0.0,
                    mpc_data={np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 1.0]).tobytes(): 0.9,
                                                               np.array([0.4, 1.0]).tobytes(): 0.1}},
                    mass=True, source=lambda v, c: (c.x[0] + 3 * c.x[1]) * v.value)


@dtype_c128
def test_pipeline_inhomogeneous_bc_complex(dtype):
    """tests/test_mpc_pipeline.py::test_pipeline_inhomogeneous_bc at complex128."""
    _check_pipeline(dtype, cell_type="triangle", degree=2, n=6, marker=lambda x: np.isclose(x[0], 0.0), g=2.5,
                    mpc_data={np.array([1.0, 0.5]).tobytes(): {np.array([0.5, 0.5]).tobytes(): 0.6}},
                    mass=False, source=lambda v, c: 1.0 * v.value)


@dtype_c128
def test_matrix_vector_consistency_complex(dtype):
    """tests/test_mpc_pipeline.py::test_matrix_vector_consistency at complex128."""
    def space_mpc(pkg, dt):
        mod, F, M, _, _ = PKGS[pkg]
        V = mod.functionspace(M.create_unit_square(4, 4), ("Lagrange", 1))
        mpc = _mpc(pkg, V, dt)
        mpc.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 0.0]).tobytes(): 0.5}})
        mpc.finalize()
        return mod, F, V, mpc

    def build(pkg, dt):
        mod, F, V, mpc = space_mpc(pkg, dt)
        return mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v)), mpc, None

    def build_rhs(pkg, dt):
        mod, F, V, mpc = space_mpc(pkg, dt)
        return mod.LinearForm(V, lambda v, c: c.x[0] * v.value), mpc

    _lhs_case(build, dtype)
    _rhs_case(build_rhs, dtype)


# ---------------------------------------------------------------------------
# tests/test_rectangular_and_nest.py
# ---------------------------------------------------------------------------


def _two_mpcs(pkg, V, Q, dtype):
    mpc_v = _mpc(pkg, V, dtype)
    mpc_v.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 0.0]).tobytes(): 0.2}},
                                    subspace_slave=0, subspace_master=0)
    mpc_v.finalize()
    mpc_q = _mpc(pkg, Q, dtype)
    mpc_q.create_general_constraint({np.array([0.0, 1.0]).tobytes(): {np.array([1.0, 0.0]).tobytes(): 0.3}})
    mpc_q.finalize()
    return mpc_v, mpc_q


@dtype_c128
def test_rectangular_assembly_complex(dtype):
    """tests/test_rectangular_and_nest.py::test_rectangular_assembly at
    complex128: K_V^H B K_Q in both packages, equal values."""
    res = {}
    for pkg in PKGS:
        mod, F, M, _, _ = PKGS[pkg]
        mesh = M.create_unit_square(4, 4)
        V = mod.functionspace(mesh, ("Lagrange", 2, (2,)))
        Q = mod.functionspace(mesh, ("Lagrange", 1))
        mpc_v, mpc_q = _two_mpcs(pkg, V, Q, dtype)
        bf = mod.BilinearForm(V, lambda p, v, c: F.div(v) * F.conj(p.value), V_trial=Q)
        B_org = mod.assemble_matrix(bf, None, dtype=dtype, **_kw(pkg)).to_scipy()
        B_mpc = mod.assemble_matrix(bf, (mpc_v, mpc_q), dtype=dtype).to_scipy()
        K = gather_transformation_matrix if pkg == "pt" else jx_K
        ref = (K(mpc_v).T.conj() @ B_org @ K(mpc_q)).tocsr()
        keep_r = np.setdiff1d(np.arange(V.num_dofs), np.asarray(mpc_v.slaves))
        keep_c = np.setdiff1d(np.arange(Q.num_dofs), np.asarray(mpc_q.slaves))
        diff = ref - B_mpc[keep_r][:, keep_c]
        assert B_mpc.dtype == np.dtype(dtype) and (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-9
        res[pkg] = B_mpc
    assert _rel(res["pt"], res["jx"]) <= 1e-12


@dtype_c128
def test_nest_stokes_like_complex(dtype):
    """tests/test_rectangular_and_nest.py::test_nest_stokes_like at
    complex128: the nest matvec on a complex vector equals scipy's bmat
    product, the nest vector is finite, both equal the JAX package's."""
    res = {}
    x = np.random.default_rng(0).standard_normal(1).astype(dtype)
    for pkg in PKGS:
        mod, F, M, _, _ = PKGS[pkg]
        mesh = M.create_unit_square(3, 3)
        V = mod.functionspace(mesh, ("Lagrange", 2, (2,)))
        Q = mod.functionspace(mesh, ("Lagrange", 1))
        mpc_v, mpc_q = _two_mpcs(pkg, V, Q, dtype)
        a00 = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)))
        a01 = mod.BilinearForm(V, lambda p, v, c: -F.div(v) * F.conj(p.value), V_trial=Q)
        a10 = mod.BilinearForm(Q, lambda u, q, c: -F.div(u) * F.conj(q.value), V_trial=V)
        a_nest = [[a00, a01], [a10, None]]
        A = mod.create_matrix_nest(a_nest, [mpc_v, mpc_q])
        mod.assemble_matrix_nest(A, a_nest, [mpc_v, mpc_q])
        S = A.to_scipy()
        if x.shape[0] == 1:
            rng = np.random.default_rng(0)
            x = (rng.standard_normal(S.shape[1]) + 1j * rng.standard_normal(S.shape[1])).astype(dtype)
        y = _np(A.matvec(torch.as_tensor(x) if pkg == "pt" else jnp.asarray(x)))
        assert np.abs(y - S @ x).max() < 1e-10
        L = [mod.LinearForm(V, lambda v, c, pkg=pkg: F.inner(_stack(pkg, c, 1.0, 1.0), v)),
             mod.LinearForm(Q, lambda q, c: 0.0 * q.value)]
        b = mod.create_vector_nest(L, [mpc_v, mpc_q])
        mod.assemble_vector_nest(b, L, [mpc_v, mpc_q])
        assert np.isfinite(_np(b.array)).all()
        res[pkg] = (S, y, _np(b.array))
    for got, ref in zip(res["pt"], res["jx"]):
        assert _rel(got, ref) <= 1e-12


# ---------------------------------------------------------------------------
# tests/test_slip_and_periodic.py
# ---------------------------------------------------------------------------


@dtype_c128
@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
def test_periodic_topological_complex(cell_type, dtype):
    """tests/test_slip_and_periodic.py::test_periodic_topological at complex128."""
    def build(pkg, dt):
        mod, F, M, _, _ = PKGS[pkg]
        mesh = M.create_unit_square(4, 4, cell_type)
        V = mod.functionspace(mesh, ("Lagrange", 1))
        mt = M.meshtags(mesh, 1, M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 1.0)), 2)
        bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(
            V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)

        def relation(x):
            out = np.copy(x)
            out[0] = 1.0 - x[0]
            return out

        mpc = _mpc(pkg, V, dt)
        mpc.create_periodic_constraint_topological(V, mt, 2, relation, [bc])
        mpc.finalize()
        assert mpc.num_local_slaves == 3
        return mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v))), mpc, [bc]

    _lhs_case(build, dtype)


@dtype_c128
def test_periodic_scale_complex(dtype):
    """tests/test_slip_and_periodic.py::test_periodic_scale at complex128:
    every coefficient has modulus 0.5, and the tables equal the JAX
    package's."""
    tabs = {}
    for pkg in PKGS:
        mod, F, M, _, _ = PKGS[pkg]
        V = mod.functionspace(M.create_unit_square(4, 4), ("Lagrange", 1))
        mpc = _mpc(pkg, V, dtype)
        mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                                   lambda x: np.stack([1.0 - x[0], x[1]]), [], scale=0.5)
        mpc.finalize()
        coeffs, _ = mpc.coefficients
        coeffs = _np(coeffs)
        assert coeffs.dtype == np.dtype(dtype) and np.allclose(np.abs(coeffs[np.abs(coeffs) > 1e-13]), 0.5)
        tabs[pkg] = (np.asarray(mpc.slaves), coeffs, _np(mpc.masters[0]))
    for got, ref in zip(tabs["pt"], tabs["jx"]):
        assert np.array_equal(got, ref)


@dtype_c128
def test_periodic_vector_subspace_complex(dtype):
    """tests/test_slip_and_periodic.py::test_periodic_vector_subspace at complex128."""
    def build(pkg, dt):
        mod, F, M, _, _ = PKGS[pkg]
        V = mod.functionspace(M.create_unit_square(4, 4), ("Lagrange", 1, (2,)))
        mpc = _mpc(pkg, V, dt)
        mpc.create_periodic_constraint_geometrical(V.sub(1), lambda x: np.isclose(x[0], 1.0),
                                                   lambda x: np.stack([1.0 - x[0], x[1]]), [])
        mpc.finalize()
        assert (np.asarray(mpc.slaves) % 2 == 1).all()
        return mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v))), mpc, None

    _lhs_case(build, dtype)


# ---------------------------------------------------------------------------
# tests/test_surface_integral.py (the cases of test_torch_surface_integral)
# ---------------------------------------------------------------------------


@dtype_c128
@pytest.mark.parametrize("case,compare", [(surface._rhs_case, "rhs"), (surface._bilinear_case, "lhs"),
                                          (surface._coefficient_case, "rhs")],
                         ids=["surface_rhs_with_mpc", "surface_bilinear_with_mpc", "surface_with_coefficient"])
def test_surface_integral_complex(case, compare, dtype):
    """tests/test_surface_integral.py's three tests at complex128, on
    tests/test_torch_surface_integral.py's builders."""
    mj, (org_j, mpc_j) = case("jx", dtype)
    mp, (org_p, mpc_p) = case("pt", dtype)
    if compare == "lhs":
        compare_mpc_lhs(org_p, mpc_p, mp)
        jx_lhs(org_j, mpc_j, mj)
        assert mpc_p.dtype == np.dtype(dtype) and _rel(mpc_p, mpc_j) <= 1e-12
    else:
        compare_mpc_rhs(_np(org_p), _np(mpc_p), mp)
        jx_rhs(_np(org_j), _np(mpc_j), mj)
        assert _np(mpc_p).dtype == np.dtype(dtype) and _rel(_np(mpc_p), _np(mpc_j)) <= 1e-12


# ---------------------------------------------------------------------------
# tests/test_vector_poisson.py
# ---------------------------------------------------------------------------


@dtype_c128
@pytest.mark.parametrize("slave_comp,master_comp", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_vector_poisson_subspace_constraint_complex(slave_comp, master_comp, dtype):
    """tests/test_vector_poisson.py::test_vector_poisson_subspace_constraint
    at complex128: matrix and vector."""
    def space_mpc(pkg, dt):
        mod, F, M, _, _ = PKGS[pkg]
        V = mod.functionspace(M.create_unit_square(4, 4), ("Lagrange", 1, (2,)))
        mpc = _mpc(pkg, V, dt)
        mpc.create_general_constraint({np.array([1.0, 0.0]).tobytes(): {np.array([0.0, 1.0]).tobytes(): 0.1}},
                                      subspace_slave=slave_comp, subspace_master=master_comp)
        mpc.finalize()
        return mod, F, V, mpc

    def build(pkg, dt):
        mod, F, V, mpc = space_mpc(pkg, dt)
        return mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v))), mpc, None

    def build_rhs(pkg, dt):
        mod, F, V, mpc = space_mpc(pkg, dt)
        return mod.LinearForm(V, lambda v, c: F.inner(_stack(pkg, c, -5.0 * c.x[1], 7.0 * c.x[0]), v)), mpc

    _lhs_case(build, dtype)
    _rhs_case(build_rhs, dtype)


@dtype_c128
def test_elasticity_sym_grad_complex(dtype):
    """tests/test_vector_poisson.py::test_elasticity_sym_grad at complex128."""
    def build(pkg, dt):
        mod, F, M, _, _ = PKGS[pkg]
        V = mod.functionspace(M.create_unit_square(3, 3), ("Lagrange", 1, (2,)))
        mpc = _mpc(pkg, V, dt)
        mpc.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {
            np.array([0.0, 0.0]).tobytes(): 0.3, np.array([1.0, 0.0]).tobytes(): 0.2}})
        mpc.finalize()
        return mod.BilinearForm(V, _elast(F)), mpc, None

    _lhs_case(build, dtype)


# ---------------------------------------------------------------------------
# A Bloch phase: complex constraint coefficients
# ---------------------------------------------------------------------------


def _bloch(pkg, n=3, cube=True, dtype=C128, scale=BLOCH):
    """P1 on the unit cube (square) of n^3 (n^2) cells, u(1, y, z) =
    e^{i pi/3} u(0, y, z), Dirichlet 0 at y=0/1, grad-grad plus mass, a
    complex source."""
    mod, F, M, _, _ = PKGS[pkg]
    mesh = M.create_unit_cube(n, n, n) if cube else M.create_unit_square(n, n)
    rel = (lambda x: np.stack([1.0 - x[0], x[1], x[2]])) if cube else (lambda x: np.stack([1.0 - x[0], x[1]]))
    V = mod.functionspace(mesh, ("Lagrange", 1))
    bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = _mpc(pkg, V, dtype)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0), rel, [bc], scale=scale)
    mpc.finalize()
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v), quad_degree=2)
    L = mod.LinearForm(V, lambda v, c: (4.0 + 2j * c.x[0]) * v.value)
    return V, a, L, mpc, bc


def _bloch_lattice(pkg, fmt, **kw):
    V, a, L, mpc, bc = _bloch(pkg, **kw)
    if pkg == "pt":
        return pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=C128, side_format=fmt, device="cpu").assemble()
    return jx_lattice(a, mpc, bcs=[bc], dtype=C128, side_format=fmt).assemble()


@pytest.mark.parametrize("fmt", ["csr", "cells"])
def test_bloch_side_blocks_match_jax(fmt):
    """The side blocks conj(K_e)^T A_e K_e of the slave cells under a Bloch
    phase, assembled over the slots ("csr": side_data) or kept per cell
    ("cells": side_Aep), equal the JAX package's to 1e-12 relative; the
    operator is Hermitian and equals K^H A K of the unconstrained matrix."""
    Ap, Aj = _bloch_lattice("pt", fmt), _bloch_lattice("jx", fmt)
    if fmt == "csr":
        assert np.array_equal(Ap.side_cols.numpy(), np.asarray(Aj.side_cols))
        got, ref = Ap.side_data.numpy(), np.asarray(Aj.side_data)
    else:
        got, ref = Ap.side_Aep.numpy(), np.asarray(Aj.side_Aep)
    assert got.dtype == np.complex128 and np.abs(ref.imag).max() > 1e-2
    assert _rel(got, ref) <= 1e-12
    S = Ap.to_scipy()
    assert abs(S - S.conj().T).max() <= 1e-15 * abs(S).max()
    V, a, L, mpc, bc = _bloch("pt")
    compare_mpc_lhs(pt.assemble_matrix(a, None, bcs=[bc], dtype=C128, device="cpu").to_scipy(), S, mpc)


@pytest.mark.parametrize("cube", [True, False], ids=["3-D", "2-D"])
def test_bloch_phase_is_refused_by_fold(cube):
    """A Bloch-phase constraint is no plane identification: "fold" raises
    ValueError in both packages, and LinearProblem's route takes "cells"."""
    for pkg in PKGS:
        with pytest.raises(ValueError, match="identification"):
            _bloch_lattice(pkg, "fold", cube=cube)
    V, a, L, mpc, bc = _bloch("pt", cube=cube)
    prob = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-12})
    A, _ = prob.assemble()
    assert A.fold_axis is None and A.side_Aep is not None and A.dtype == torch.complex128


def test_bloch_linear_problem_meets_the_oracle():
    """LinearProblem with a Bloch phase and a complex source (the lattice
    "cells" path): K (K^H A K)^-1 K^H b to 1e-10 with A, b and K of the
    JAX package's lattice operator ("csr") and vector."""
    V, a, L, mpc, bc = _bloch("pt")
    u = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-13}).solve().x.array.numpy()
    Vj, aj, Lj, mj, bcj = _bloch("jx")
    A = jx_lattice(aj, None, bcs=[bcj], dtype=C128, side_format="csr").assemble().to_scipy()
    b = np.asarray(jx.set_bc(jx.apply_lifting(jx.assemble_vector(Lj, None, dtype=C128), [aj], [[bcj]], None,
                                              dtype=C128), [bcj]))
    K = jx_K(mj)
    u_ref = K @ spla.spsolve((K.conj().T @ A @ K).tocsc(), K.conj().T @ b)
    assert np.abs(u_ref.imag).max() > 1e-3 and np.abs(u - u_ref).max() < 1e-10 * np.abs(u_ref).max()
    # the slaves carry the phase: u(1, y, z) = e^{i pi/3} u(0, y, z)
    masters = mpc._np_masters[:, 0]
    assert np.abs(u[np.asarray(mpc.slaves)] - BLOCH * u[masters]).max() < 1e-14


def test_bloch_general_assembler_meets_the_oracle():
    """The general assembler under a Bloch phase equals K^H A K; the JAX
    package's does not: its slave-cell einsum keeps the element kernel's
    real dtype (preferred_element_type=Ae.dtype,
    dolfinx_mpc_tpu/ops/assemble.py:290-293), which drops the imaginary
    part of conj(K_e)^T A_e K_e (ROADMAP queue 3: 1.51 at n=4, tolerance
    5e-12)."""
    out = {}
    for pkg, check in (("pt", compare_mpc_lhs), ("jx", jx_lhs)):
        mod = PKGS[pkg][0]
        V, a, L, mpc, bc = _bloch(pkg, n=4, cube=False)
        A_org = mod.assemble_matrix(a, None, bcs=[bc], dtype=C128, **_kw(pkg)).to_scipy()
        out[pkg] = (A_org, mod.assemble_matrix(a, mpc, bcs=[bc]).to_scipy(), mpc)
    compare_mpc_lhs(*out["pt"])
    with pytest.raises(AssertionError, match="K\\^H A K mismatch"):
        jx_lhs(*out["jx"])
    assert _rel(out["pt"][1], _bloch_lattice("pt", "csr", n=4, cube=False).to_scipy()) <= 1e-12


# ---------------------------------------------------------------------------
# GMG on complex levels: the Hermitian coarse inverse
# ---------------------------------------------------------------------------


def test_hermitian_coarse_inverse_on_a_bloch_level():
    """dense_coarse_inverse of a Bloch-phase coarse level (P1, 4^3 cells,
    "csr"): its product with C is the identity to 1e-10 and it is
    Hermitian; the JAX package's is the inverse of C's real part, 0.196 away
    from the identity (ROADMAP queue 3).  A real operator's inverse is the
    float64 Cholesky inverse bit for bit, as before complex levels."""
    import warnings

    import scipy.linalg as sla

    from dolfinx_mpc_tpu.la.gmg import dense_coarse_inverse as jx_dci
    from dolfinx_mpc_tpu_torch.la.gmg import dense_coarse_inverse

    Ap, Aj = _bloch_lattice("pt", "csr", n=4), _bloch_lattice("jx", "csr", n=4)
    C = Ap.to_scipy().toarray()
    I = np.eye(C.shape[0])
    inv = dense_coarse_inverse(Ap).numpy()
    assert inv.dtype == np.complex128 and np.abs(C @ inv - I).max() <= 1e-10
    assert np.abs(inv - inv.conj().T).max() == 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX package's cast to float64 warns
        inv_j = np.asarray(jx_dci(Aj))
    assert np.abs(C @ inv_j - I).max() > 0.1
    Ar = _bloch_lattice("pt", "csr", n=4, dtype=np.float64, scale=1.0)
    Cr = Ar.to_scipy().toarray()
    Cr = 0.5 * (Cr + Cr.T)
    ref = sla.cho_solve(sla.cho_factor(Cr), np.eye(Cr.shape[0]))
    assert np.array_equal(dense_coarse_inverse(Ar).numpy(), 0.5 * (ref + ref.T))


def test_gmg_cg_on_bloch_levels():
    """LatticeGMG over Bloch-phase "csr" levels (8^3 -> 4^3 -> 2^3 cells,
    complex128): real free masks and Gershgorin bounds (as the JAX package
    keeps them), a self-adjoint V-cycle (<M r, s> = <r, M s> to 1e-12), and
    CG to rtol 1e-10 within 1e-8 of K (K^H A K)^-1 K^H b."""
    def make(m):
        V, a, L, mpc, bc = _bloch("pt", n=m)
        return pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=C128, side_format="csr", device="cpu")

    ops, masks = pt.build_gmg_hierarchy(make, 8, 3, min_n=2)
    assert [m.dtype for m in masks] == [torch.float64] * 3 and [o.dtype for o in ops] == [torch.complex128] * 3
    M = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev")
    assert all(isinstance(b, float) for b in M._bounds) and M.coarse_inv.dtype == torch.complex128
    rng = np.random.default_rng(3)
    r, s = (torch.as_tensor((rng.standard_normal(ops[0].shape[0]) + 1j * rng.standard_normal(ops[0].shape[0]))
                            * masks[0].numpy()) for _ in range(2))
    lhs, rhs = torch.vdot(M(r), s), torch.vdot(r, M(s))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    V, a, L, mpc, bc = _bloch("pt", n=8)
    b = pt.set_bc(pt.assemble_vector(L, mpc), [bc])
    x, its, _ = pt.cg(ops[0].matvec, b, M=M, rtol=1e-10, atol=0.0, max_it=200)
    assert its < 20
    A = pt.assemble_matrix(a, None, bcs=[bc], dtype=C128, device="cpu").to_scipy()
    bo = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, dtype=C128, device="cpu"), [a], [[bc]], None,
                                    dtype=C128, device="cpu"), [bc]).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.conj().T @ A @ K).tocsc(), K.conj().T @ bo)
    assert np.abs(mpc.finalized.backsubstitution(x).numpy() - u_ref).max() < 1e-8


# ---------------------------------------------------------------------------
# the Krylov solvers and the eigensolver on complex Hermitian systems
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bloch_systems():
    """The 8 x 8 Bloch-phase operator ("csr") of both packages and a complex
    right-hand side."""
    Ap = _bloch_lattice("pt", "csr", n=8, cube=False)
    Aj = _bloch_lattice("jx", "csr", n=8, cube=False)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(Ap.shape[0]) + 1j * rng.standard_normal(Ap.shape[0])
    return Aj, Ap, b


@pytest.mark.parametrize("ksp", ["cg", "bcgs", "gmres"])
@pytest.mark.parametrize("pc", ["jacobi", "chebyshev"])
def test_krylov_on_a_bloch_system_matches_jax(bloch_systems, ksp, pc):
    """cg, bicgstab and gmres with Jacobi or Chebyshev (one real numpy
    probe for both packages' power iterations) on the complex Hermitian
    system: the JAX package's count, iterates to 1e-10 relative."""
    from dolfinx_mpc_tpu.la import solvers as js
    from dolfinx_mpc_tpu_torch.la import solvers as ps

    Aj, Ap, b = bloch_systems
    probe = np.random.default_rng(5).standard_normal(b.shape[0])
    if pc == "jacobi":
        Mj, Mp = js.jacobi_preconditioner(Aj.diagonal()), ps.jacobi_preconditioner(Ap.diagonal())
    else:
        Mj = js.chebyshev_preconditioner(Aj.matvec, Aj.diagonal(), probe=jnp.asarray(probe.astype(C128)))
        Mp = ps.chebyshev_preconditioner(Ap.matvec, Ap.diagonal(), probe=probe)
    fj, fp = {"cg": (js.cg, ps.cg), "bcgs": (js.bicgstab, ps.bicgstab), "gmres": (js.gmres, ps.gmres)}[ksp]
    xj, ij, _ = fj(Aj.matvec, jnp.asarray(b), M=Mj, rtol=1e-12, max_it=5000)
    xp, ip, _ = fp(Ap.matvec, torch.as_tensor(b), M=Mp, rtol=1e-12, max_it=5000)
    assert ip == int(ij) and ip > 1 and xp.dtype == torch.complex128
    assert _rel(xp.numpy(), np.asarray(xj)) <= 1e-10


def test_eigsh_on_a_bloch_pencil_matches_jax():
    """eigsh_shift_invert on the Bloch-phase pencil (stiffness with
    diagval 1e4, mass with diagval 1, "csr", 10 x 10): real eigenvalues
    equal to the JAX package's and to scipy's dense eigh of the Hermitian
    pencil to 1e-8 relative, with the JAX package's counts."""
    from dolfinx_mpc_tpu.la import solvers as js
    from dolfinx_mpc_tpu.la.eig import eigsh_shift_invert as jx_eigsh
    from dolfinx_mpc_tpu_torch.la import eig as pe, solvers as ps

    nev = 3
    res = {}
    for pkg in PKGS:
        mod, F, _, _, _ = PKGS[pkg]
        V, a, L, mpc, bc = _bloch(pkg, n=10, cube=False)
        k_form = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)))
        m_form = mod.BilinearForm(V, lambda u, v, c: F.inner(u, v))
        if pkg == "pt":
            K, Mm = (pt.assemble_matrix_lattice(f, mpc, bcs=[bc], dtype=C128, diagval=dv, side_format="csr",
                                                device="cpu").assemble() for f, dv in ((k_form, 1e4), (m_form, 1.0)))
            lam, U, info = pe.eigsh_shift_invert(K, Mm, nev, pc=ps.jacobi_preconditioner(K.diagonal()), tol=1e-9)
        else:
            K, Mm = (jx_lattice(f, mpc, bcs=[bc], dtype=C128, diagval=dv, side_format="csr").assemble()
                     for f, dv in ((k_form, 1e4), (m_form, 1.0)))
            lam, U, info = jx_eigsh(K, Mm, nev, pc=js.jacobi_preconditioner(K.diagonal()), tol=1e-9)
        res[pkg] = (np.sort(np.asarray(lam)), info, K, Mm)
    lam, info, K, Mm = res["pt"][:4]
    assert np.allclose(lam, res["jx"][0], rtol=1e-8, atol=0)
    assert (info["outer"], info["inner"]) == (res["jx"][1]["outer"], res["jx"][1]["inner"])
    # the operators' own pencil (the slave and bc rows sit at 1e4 / 1)
    import scipy.linalg as sla

    vals = sla.eigh(K.to_scipy().toarray(), Mm.to_scipy().toarray(), eigvals_only=True)[:nev]
    assert np.allclose(lam, vals, rtol=1e-8, atol=0)


def test_amg_on_complex_contact_meets_the_oracle():
    """Tied contact (NB=4/NT=3) in complex128 with a complex body force:
    smoothed-aggregation AMG (coarse_size 100, so that it has levels) takes
    the real operator's hierarchy with complex values, and BELL + AMG + CG
    meets K (K^H A K)^-1 K^H b to 1e-10 in the real operator's count."""
    from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy

    res = {}
    for dt in (np.float64, C128):
        mod, F, M, U, _ = PKGS["pt"]
        bot = M.create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (4, 4, 4))
        top = M.create_box((0.0, 0.0, 1.0), (1.0, 1.0, 2.0), (3, 3, 3))
        mesh = M.Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                      bot.cell_type)
        V = pt.functionspace(mesh, ("Lagrange", 1, (3,)))
        mpc = _mpc("pt", V, dt)
        mpc.create_contact_inelastic_condition(_interface_tags(M, mesh, axis=2), 1, 2)
        mpc.finalize()
        bcs = [pt.dirichletbc(np.zeros(3), pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V)]
        a = pt.BilinearForm(V, _elast(F))
        c = 0.5j if dt == C128 else 0.0
        L = pt.LinearForm(V, lambda v, ctx: (1.0 + c * ctx.x[0]) * v.value[..., 0] - v.value[..., 2])
        As = pt.assemble_matrix(a, mpc, bcs).to_scipy()
        b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
        amg = smoothed_aggregation_amg(As, bs=3, dtype=dt, nullspace=U.rigid_motions_nullspace(V), coarse_size=100,
                                       device="cpu")
        B = bell_from_scipy(As, dtype=dt, device="cpu")
        B.pack()
        x, its, _ = pt.cg(B.matvec, b, M=amg, rtol=1e-12, atol=0.0, max_it=500)
        u = mpc.finalized.backsubstitution(x).numpy()
        A0 = pt.assemble_matrix(a, None, bcs, dtype=dt, device="cpu").to_scipy()
        b0 = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, dtype=dt, device="cpu"), [a], [bcs], dtype=dt,
                                        device="cpu"), bcs).numpy()
        K = gather_transformation_matrix(mpc)
        u_ref = K @ spla.spsolve((K.conj().T @ A0 @ K).tocsc(), K.conj().T @ b0)
        assert u.dtype == np.dtype(dt) and np.abs(u - u_ref).max() <= 1e-10 * np.abs(u_ref).max()
        res[dt] = (its, [op.shape for op in amg.ops], amg.coarse_inv.dtype)
    assert len(res[C128][1]) > 1 and res[C128][:2] == res[np.float64][:2] and res[C128][2] == torch.complex128


@pytest.mark.parametrize("dtype", [np.complex64, C128], ids=["c64", "c128"])
def test_plain_spmvs_take_complex(dtype):
    """The plain versions of K2, K7, K6 and K8 (what the wrappers run on CPU
    tensors, and what the card kernels are held against) on complex random
    operators equal scipy's product of the same operator: 5e-6 relative in
    complex64, 1e-12 in complex128."""
    from dolfinx_mpc_tpu_torch.la import bell as BL
    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, DIAMatrix

    tol = 5e-6 if dtype == np.complex64 else 1e-12
    rng = np.random.default_rng(9)
    crandn = lambda *shape: (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(dtype)  # noqa: E731

    def check(y, S, x):
        ref = S.astype(C128) @ np.asarray(x, C128)
        assert y.dtype == torch.complex64 if dtype == np.complex64 else y.dtype == torch.complex128
        assert np.abs(y.numpy() - ref).max() <= tol * np.abs(ref).max()

    offs = pt.assemble_matrix_lattice(_bloch("pt", n=2)[1], None, dtype=C128, side_format="csr",
                                      device="cpu").offsets
    for bs, vshape in ((1, (4, 5, 6)), (3, (3, 4, 5))):
        dia = DIAMatrix(torch.as_tensor(crandn(len(offs), bs, bs, *vshape)), offs, vshape, bs)
        x = crandn(dia.shape[0])
        check(LK.dia_matvec_plain(dia.data, offs, vshape, bs, torch.as_tensor(x)), dia.to_scipy(), x)
    V2 = pt.functionspace(pm.create_unit_cube(2, 2, 2), ("Lagrange", 2))
    m2 = _mpc("pt", V2)
    m2.create_periodic_constraint_geometrical(V2, lambda x: np.isclose(x[0], 1.0),
                                              lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    m2.finalize()
    trips = pt.assemble_matrix_lattice(pt.BilinearForm(V2, lambda u, v, c: pf.inner(pf.grad(u), pf.grad(v))),
                                       m2, dtype=C128, side_format="fold", device="cpu").trips
    blk = BlockDIAMatrix(torch.as_tensor(crandn(len(trips), 3, 3, 3)), trips, (5, 5, 5), (2, 2, 2))
    x = crandn(125)
    check(blk.from_blocked(LK.blocked_matvec_plain(blk.data, trips, blk.classes, blk.to_blocked(
        torch.as_tensor(x)))), blk.to_scipy(), x)
    S = sp.random(300, 280, density=0.05, random_state=3, format="csr")
    S = (S + 1j * sp.random(300, 280, density=0.05, random_state=4, format="csr")).tocsr()
    B = BL.bell_from_scipy(S, dtype=dtype, mt_cap=1, device="cpu")
    x = crandn(280)
    check(BL.bell_packed_matvec_plain(B.pack(), torch.as_tensor(x)), S, x)
