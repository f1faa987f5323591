"""Parity of the port's constraint builders and their utilities with the JAX
package: slip, contact slip, dictionary / general and point-to-point
constraints (constraints.py, multipointconstraint.py), the rotation and the
normal approximations (utils/mpc_utils.py), the K^H A K / K^H b checks
(utils/verification.py), and slip solves against the oracle.

The builders are host numpy code copied from the JAX package, so their
tables must be equal bit for bit; a projected normal is a CG solve (1e-12
relative); solutions 1e-8 against the oracle K (K^T A K)^-1 K^T b and the
JAX package (tests/conftest.py:42-45).  The JAX package's exterior-facet
normal is inward on negatively oriented tets (ROADMAP queue 3), so its
projected normal is compared on 2-D meshes, and on tets the port's is held
against the averaged normal instead.
"""

import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu import constraints as jc
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.utils import mpc_utils as ju
from dolfinx_mpc_tpu_torch import constraints as pc
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.utils import (
    compare_mpc_lhs,
    compare_mpc_rhs,
    gather_transformation_matrix,
    mpc_utils as pu,
)

PKGS = {"jx": (jx, jf, jm, jc, ju), "pt": (pt, pf, pm, pc, pu)}


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


def _values(f):
    a = f.x.array
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _equal_data(got, ref):
    for name in ("slaves", "masters", "coeffs", "owners", "offsets"):
        g, r = getattr(got, name), np.asarray(getattr(ref, name))
        assert g.dtype == r.dtype and np.array_equal(g, r), name


def _stacked(M, gdim, nb, nt, theta):
    """Two non-matching boxes (squares) stacked at the last axis = 1, the
    interface tagged 1 (upper side) / 2 (lower side) before the whole mesh
    is rotated by theta (about (1, 1, 0) in 3-D)."""
    if gdim == 2:
        bot = M.create_rectangle((0.0, 0.0), (1.0, 1.0), (nb, nb))
        top = M.create_rectangle((0.0, 1.0), (1.0, 2.0), (nt, nt))
    else:
        bot = M.create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
        top = M.create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = M.Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                  bot.cell_type)
    fverts, _, f2c = mesh.facets()
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(np.isclose(mesh.points[fverts][:, :, gdim - 1], 1.0).all(axis=1) & ext)
    up = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, gdim - 1] > 1.0
    mt = M.meshtags(mesh, gdim - 1, iface, np.where(up, 1, 2))
    if gdim == 2:
        R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    else:
        R = pu.rotation_matrix([1.0, 1.0, 0.0], theta)
    mesh.points[:] = mesh.points @ R.T
    return mesh, mt, R


@functools.lru_cache(maxsize=None)
def _contact(pkg, gdim, theta):
    mod, F, M, C, U = PKGS[pkg]
    mesh, mt, R = _stacked(M, gdim, 4 if gdim == 2 else 3, 3 if gdim == 2 else 2, theta)
    V = mod.functionspace(mesh, ("Lagrange", 1, (gdim,)))
    return V, mt, R, U.create_normal_approximation(V, mt, 1, **_kw(pkg))


def _slip_square(pkg, theta):
    """A 5x5 P1 vector square rotated by theta, its (rotated) x=1 edge tagged 1,
    Dirichlet on the rotated x=0 edge."""
    mod, F, M, C, U = PKGS[pkg]
    mesh = M.create_unit_square(5, 5)
    facets = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 1.0))
    mt = M.meshtags(mesh, 1, facets, 1)
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mesh.points[:] = mesh.points @ R.T
    V = mod.functionspace(mesh, ("Lagrange", 1, (2,)))
    bc = mod.dirichletbc(np.zeros(2), mod.locate_dofs_geometrical(V, lambda x: np.isclose((R.T @ x[:2])[0], 0.0)),
                         V)
    return V, mt, bc, U.create_normal_approximation(V, mt, 1, **_kw(pkg))


# ---- tables --------------------------------------------------------------


@pytest.mark.parametrize("theta", [0.0, 0.35])
def test_slip_tables_2d_equal_jax(theta):
    data = []
    for pkg in ("jx", "pt"):
        V, mt, bc, n = _slip_square(pkg, theta)
        data.append(PKGS[pkg][3].create_slip_condition(V, (mt, 1), n, [bc]))
    assert len(data[1].slaves) > 0
    _equal_data(data[1], data[0])


def test_slip_tables_3d_equal_jax():
    """Slip on the rotated interface of the stacked cubes: three nonzero
    normal components per block."""
    data = []
    for pkg in ("jx", "pt"):
        V, mt, R, n = _contact(pkg, 3, 0.3)
        data.append(PKGS[pkg][3].create_slip_condition(V, (mt, 1), n, []))
    assert len(data[1].masters) == 2 * len(data[1].slaves) > 0
    _equal_data(data[1], data[0])


@pytest.mark.parametrize("gdim,theta", [(2, 0.0), (2, 0.35), (3, 0.0), (3, 0.3)],
                         ids=["2d-flat", "2d-rotated", "3d-flat", "3d-rotated"])
def test_contact_slip_tables_equal_jax(gdim, theta):
    tabs = []
    for pkg in ("jx", "pt"):
        V, mt, R, n = _contact(pkg, gdim, theta)
        mpc = PKGS[pkg][0].MultiPointConstraint(V, **_kw(pkg))
        mpc.create_contact_slip_condition(mt, 1, 2, n)
        mpc.finalize()
        tabs.append((mpc.slaves, *mpc.masters, *mpc.coefficients, np.asarray(mpc._np_masters),
                     np.asarray(mpc._np_coeffs)))
    assert len(tabs[1][0]) > 0
    for g, r in zip(*tabs[::-1]):
        assert np.array_equal(g, np.asarray(r))


DICT = {np.array([1.0, 1.0]).tobytes(): {np.array([1.0, 0.0]).tobytes(): 0.9,
                                          np.array([0.0, 0.5]).tobytes(): -0.25},
        np.array([0.5, 1.0]).tobytes(): {np.array([0.5, 0.0]).tobytes(): 0.4}}


@pytest.mark.parametrize("shape,sub_s,sub_m", [((), None, None), ((2,), None, None), ((2,), 0, 1), ((2,), 1, 1)],
                         ids=["scalar", "vector", "sub-0-1", "sub-1-1"])
def test_dictionary_tables_equal_jax(shape, sub_s, sub_m):
    """create_dictionary_constraint and MultiPointConstraint.create_general_constraint
    with and without sub-spaces."""
    out = []
    for pkg in ("jx", "pt"):
        mod, F, M, C, U = PKGS[pkg]
        V = mod.functionspace(M.create_unit_square(4, 4), ("Lagrange", 1, shape) if shape else ("Lagrange", 1))
        data = C.create_dictionary_constraint(V, DICT, sub_s, sub_m)
        mpc = mod.MultiPointConstraint(V, **_kw(pkg))
        mpc.create_general_constraint(DICT, sub_s, sub_m)
        mpc.finalize()
        out.append((data, mpc.slaves, mpc._np_masters, mpc._np_coeffs))
    _equal_data(out[1][0], out[0][0])
    for g, r in zip(out[1][1:], out[0][1:]):
        assert np.array_equal(g, np.asarray(r))


@pytest.mark.parametrize("gdim,vector", [(2, None), (2, (0.0, 1.0)), (3, None), (3, (0.0, 0.0, 1.0)),
                                         (3, (0.3, -0.5, 1.0))], ids=["2d", "2d-vector", "3d", "3d-vector",
                                                                      "3d-tilted"])
def test_point_to_point_tables_equal_jax(gdim, vector):
    data = []
    for pkg in ("jx", "pt"):
        mod, F, M, C, U = PKGS[pkg]
        mesh = _stacked(M, gdim, 3, 2, 0.0)[0]
        V = mod.functionspace(mesh, ("Lagrange", 1, (gdim,)))
        top, low = np.array([1.0] * (gdim - 1) + [2.0]), np.array([0.3] * (gdim - 1) + [0.4])
        kw = {} if vector is None else {"vector": np.asarray(vector)}
        data.append(C.create_point_to_point_constraint(V, top, low, **kw))
    assert len(data[1].masters) > 0
    _equal_data(data[1], data[0])


# ---- utilities -----------------------------------------------------------


def test_rotation_matrix_exact():
    for axis, angle in (([1.0, 1.0, 0.0], 0.3), ([0.2, -0.7, 1.5], 2.1)):
        assert np.array_equal(pu.rotation_matrix(axis, angle), ju.rotation_matrix(axis, angle))


@pytest.mark.parametrize("gdim,theta", [(2, 0.35), (3, 0.3)])
def test_normal_approximations_match_jax(gdim, theta):
    """create_normal_approximation and method="average" are exact, tangent
    too; on the flat interface the projection equals the averaged normal
    (1e-12) and, in 2-D, the JAX package's projection (1e-12)."""
    Vj, mtj, _, nj = _contact("jx", gdim, theta)
    Vp, mtp, _, n_p = _contact("pt", gdim, theta)
    assert n_p.x.array.dtype == torch.float64 and np.array_equal(_values(n_p), _values(nj))
    avg = pu.facet_normal_approximation(Vp, mtp, 1, method="average", device="cpu")
    assert np.array_equal(_values(avg), _values(nj))
    tan_p = pu.facet_normal_approximation(Vp, mtp, 1, tangent=True, device="cpu")
    assert np.array_equal(_values(tan_p), _values(ju.facet_normal_approximation(Vj, mtj, 1, tangent=True)))
    proj = _values(pu.facet_normal_approximation(Vp, mtp, 1, method="project", device="cpu"))
    assert np.abs(proj - _values(nj)).max() <= 1e-12
    if gdim == 2:
        ref = _values(ju.facet_normal_approximation(Vj, mtj, 1, method="project"))
        assert np.abs(proj - ref).max() <= 1e-12


def test_compare_mpc_checks_pass_and_raise():
    """compare_mpc_lhs / compare_mpc_rhs accept an MPCMatrix, a scipy matrix,
    a tensor or an array; a perturbed constrained system raises."""
    V, mt, R, n = _contact("pt", 2, 0.35)
    mpc = pt.MultiPointConstraint(V, device="cpu")
    mpc.create_contact_slip_condition(mt, 1, 2, n)
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: pf.inner(pf.grad(u), pf.grad(v)))
    L = pt.LinearForm(V, lambda v, c: (1.0 + c.x[0]) * v.value[..., 0] - v.value[..., 1])
    A0, A = pt.assemble_matrix(a, None, device="cpu"), pt.assemble_matrix(a, mpc)
    b0, b = pt.assemble_vector(L, None, device="cpu"), pt.assemble_vector(L, mpc)
    compare_mpc_lhs(A0, A, mpc)
    compare_mpc_lhs(A0.to_scipy(), A.to_scipy(), mpc)
    compare_mpc_rhs(b0, b, mpc)
    compare_mpc_rhs(b0.numpy(), b.numpy(), mpc)
    s = int(np.flatnonzero(~mpc.is_slave)[0])
    Ab = A.to_scipy().tolil()
    Ab[s, s] += 1e-3
    with pytest.raises(AssertionError, match="K\\^H A K"):
        compare_mpc_lhs(A0, Ab.tocsr(), mpc)
    bb = b.clone()
    bb[s] += 1e-3
    with pytest.raises(AssertionError, match="K\\^H b"):
        compare_mpc_rhs(b0, bb, mpc)


# ---- solves --------------------------------------------------------------


def _elasticity(pkg, V):
    mod, F = PKGS[pkg][:2]
    return mod.BilinearForm(V, lambda u, v, c: 2.0 * F.inner(F.sym(F.grad(u)), F.sym(F.grad(v)))
                            + 1.25 * F.div(u) * F.conj(F.div(v)))


def _oracle(V, mpc, bcs, a, L):
    A = pt.assemble_matrix(a, None, bcs, device="cpu").to_scipy()
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [bcs], None), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    return K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)


def _slip_elasticity(pkg):
    """tests/test_slip_and_periodic.py:89: slip on x=1 of a 6x6 P1 vector
    square, bc at x=0, source (1, -0.5)."""
    mod, F, M, C, U = PKGS[pkg]
    mesh = M.create_unit_square(6, 6)
    V = mod.functionspace(mesh, ("Lagrange", 1, (2,)))
    mt = M.meshtags(mesh, 1, M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 1.0)), 1)
    bc = mod.dirichletbc(np.zeros(2), mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 0.0)), V)
    mpc = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc.create_slip_constraint(V, (mt, 1), U.create_normal_approximation(V, mt, 1, **_kw(pkg)), [bc])
    mpc.finalize()
    L = mod.LinearForm(V, lambda v, c: v.value[..., 0] - 0.5 * v.value[..., 1])
    return V, mpc, [bc], _elasticity(pkg, V), L


def _rotated_slip_contact(pkg, project=False):
    """tests/test_contact.py:205: the rotated stacked cubes (NB=3, NT=2),
    slip contact on the averaged (or, in the port, projected) normal,
    Dirichlet 0 at Z=0 and R (0, 0, -0.05) at Z=2 in the unrotated frame."""
    mod, F, M, C, U = PKGS[pkg]
    V, mt, R, n = _contact(pkg, 3, 0.3)
    if project:
        n = U.facet_normal_approximation(V, mt, 1, method="project", device="cpu")
    mpc = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc.create_contact_slip_condition(mt, 1, 2, n)
    mpc.finalize()

    def in_rot(marker):
        return lambda x: marker(R.T @ x[:3])

    bcs = [mod.dirichletbc(np.zeros(3), mod.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[2], 0.0))), V),
           mod.dirichletbc(R @ np.array([0.0, 0.0, -0.05]),
                           mod.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[2], 2.0))), V)]
    L = mod.LinearForm(V, lambda v, c: 0.0 * v.value[..., 0])
    return V, mpc, bcs, _elasticity(pkg, V), L


@pytest.mark.parametrize("problem", [_slip_elasticity, _rotated_slip_contact, functools.partial(
    _rotated_slip_contact, project=True)], ids=["slip-elasticity", "rotated-slip-contact", "projected-normal"])
def test_slip_solves_match_oracle_and_jax(problem):
    """LinearProblem (Jacobi-CG, rtol 1e-12) in float64 on the CPU: the
    oracle to 1e-8, the JAX package's solution to 1e-8, and u.n = 0 (slip)
    or u_s.n = u_m.n (contact) on the slave blocks."""
    V, mpc, bcs, a, L = problem("pt")
    u = pt.LinearProblem(a, L, mpc, bcs=bcs, petsc_options={"ksp_rtol": 1e-12}).solve().x.array.numpy()
    assert np.abs(u - _oracle(V, mpc, bcs, a, L)).max() < 1e-8
    key = problem.func if isinstance(problem, functools.partial) else problem
    Vj, mj, bcj, aj, Lj = key("jx")
    uj = np.asarray(jx.LinearProblem(aj, Lj, mj, bcs=bcj, petsc_options={"ksp_rtol": 1e-12}).solve().x.array)
    assert np.abs(u - uj).max() < 1e-8
    assert np.abs(u).max() > 1e-3
