"""Parity of the port's matrix-free operator, derivative and Newton drivers
with the JAX package: ops/matfree.py (MatrixFreeKTAK), fem/forms.py
(derivative, by torch.func.jvp inside the element kernel's vmaps),
problem.py (NonlinearProblem with and without its backtracking line
search, NonlinearProblemNest, the P form of LinearProblem).

Mirrors tests/test_matfree.py, tests/test_nonlinear.py,
tests/test_nonlinear_nest.py and tests/test_pform_and_linesearch.py on the
same inputs (float64).  Tolerances: Jacobians, matrix-free actions and
diagonals 1e-12 relative to their largest entry; Newton and Krylov counts
equal to the JAX package's; solutions 1e-10 against the JAX package and
1e-8 / 1e-9 against the linear or assembled references, as the mirrored
tests state.
"""

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.utils import mpc_utils as ju
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.utils import mpc_utils as pu

PKGS = {"jx": (jx, jf, jm, ju), "pt": (pt, pf, pm, pu)}


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, rtol=1e-12):
    return abs(got - ref).max() <= rtol * max(abs(ref).max(), 1e-300)


def _lib(pkg):
    """The package's array module and arctan for integrands."""
    import jax.numpy as jnp

    return {"jx": jnp, "pt": torch}[pkg]


def _periodic(pkg, n, both_planes=True):
    mod, _, M, _ = PKGS[pkg]
    V = mod.functionspace(M.create_unit_square(n, n), ("Lagrange", 1))
    marker = ((lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)) if both_planes
              else (lambda x: np.isclose(x[1], 0.0)))
    bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(V, marker), V)
    mpc = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    return V, bc, mpc


# -- matrix-free -----------------------------------------------------------


def _matfree(pkg):
    mod, F, _, _ = PKGS[pkg]
    V, bc, mpc = _periodic(pkg, 6, both_planes=False)
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))
    return V, a, mpc, bc


def test_matfree_equals_assembled():
    """The K^H A K action on vectors with zero slave entries equals the
    assembled constrained matrix's and the JAX package's matrix-free action;
    the Jacobi diagonal equals the JAX package's."""
    import jax.numpy as jnp

    from dolfinx_mpc_tpu.ops.matfree import MatrixFreeKTAK as JxMF
    from dolfinx_mpc_tpu_torch.ops.matfree import MatrixFreeKTAK as PtMF

    V, a, mpc, bc = _matfree("pt")
    Vj, aj, mpcj, bcj = _matfree("jx")
    A = pt.assemble_matrix(a, mpc, bcs=[bc], diagval=1.0, device="cpu").to_scipy()
    op, opj = PtMF(a, mpc, bcs=[bc], diagval=1.0), JxMF(aj, mpcj, bcs=[bcj], diagval=1.0)
    assert op.shape == opj.shape and op.device.type == "cpu"
    rng = np.random.default_rng(3)
    for _ in range(3):
        x = rng.standard_normal(V.num_dofs)
        y = op.matvec(torch.as_tensor(x)).numpy()
        assert _close(y, np.asarray(opj.matvec(jnp.asarray(x))))
        x[mpc.slaves] = 0.0
        assert np.abs(op.matvec(torch.as_tensor(x)).numpy() - A @ x).max() < 1e-10
    assert _close(op.diagonal().numpy(), np.asarray(opj.diagonal()))


def test_matfree_cg_solve():
    """Jacobi-CG on the matrix-free operator solves the LinearProblem's
    system (1e-9), with the JAX package's count."""
    import jax.numpy as jnp

    from dolfinx_mpc_tpu.la.solvers import cg as jx_cg, jacobi_preconditioner as jx_jac
    from dolfinx_mpc_tpu.ops.matfree import MatrixFreeKTAK as JxMF
    from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.ops.matfree import MatrixFreeKTAK as PtMF

    its = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        V, a, mpc, bc = _matfree(pkg)
        L = mod.LinearForm(V, lambda v, c: 2.0 * v.value)
        u_ref = mod.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-13}).solve()
        b = mod.set_bc(mod.apply_lifting(mod.assemble_vector(L, mpc, **_kw(pkg)), [a], [[bc]], mpc), [bc])
        if pkg == "pt":
            op = PtMF(a, mpc, bcs=[bc])
            x, its[pkg], _ = pt.cg(op.matvec, b, M=jacobi_preconditioner(op.diagonal()), rtol=1e-13)
        else:
            op = JxMF(a, mpc, bcs=[bc])
            x, k, _ = jx_cg(op.matvec, jnp.asarray(b), M=jx_jac(op.diagonal()), rtol=1e-13)
            its[pkg] = int(k)
        u = _np(mpc.finalized.backsubstitution(x))
        assert np.abs(u - _np(u_ref.x.array)).max() < 1e-9
    assert its["pt"] == its["jx"]


def test_matfree_refresh_follows_coefficients():
    """refresh() re-tabulates the element tensors after a coefficient
    changes: the action with (1 + w) u v equals the assembled matrix at the
    new w."""
    from dolfinx_mpc_tpu_torch.ops.matfree import MatrixFreeKTAK

    V, bc, mpc = _periodic("pt", 5)
    w = pt.Function(V, device="cpu")
    a = pt.BilinearForm(V, lambda u, v, c: pf.inner(pf.grad(u), pf.grad(v)) + (1.0 + c["w"].value) * u.value * v.value,
                        coefficients={"w": w})
    op = MatrixFreeKTAK(a, mpc, bcs=[bc])
    w.x.array[:] = torch.as_tensor(np.random.default_rng(2).uniform(0, 1, V.num_dofs))
    op.refresh()
    x = np.random.default_rng(4).standard_normal(V.num_dofs)
    x[mpc.slaves] = 0.0
    A = pt.assemble_matrix(a, mpc, bcs=[bc], device="cpu").to_scipy()
    assert np.abs(op.matvec(torch.as_tensor(x)).numpy() - A @ x).max() < 1e-10


# -- derivative ------------------------------------------------------------


def test_derivative_jacobian_matches_jax():
    """derivative(F, "u") of -div((1 + u^2) grad u) - 4 at a seeded u,
    and the velocity and pressure Jacobian blocks of the nonlinear Stokes
    residual at seeded (u, p): equal to the JAX package's to 1e-12."""
    mats = {}
    for pkg in PKGS:
        mod, F, M, _ = PKGS[pkg]
        V = mod.functionspace(M.create_unit_square(5, 5), ("Lagrange", 2))
        u = mod.Function(V, np.random.default_rng(1).standard_normal(V.num_dofs), **_kw(pkg))
        R = mod.LinearForm(V, lambda v, c: F.inner((1 + c["u"].value ** 2) * F.grad(c["u"]), F.grad(v)) - 4.0 * v.value,
                           coefficients={"u": u})
        Vv = mod.functionspace(M.create_unit_square(3, 3), ("Lagrange", 2, (2,)))
        Q = mod.functionspace(Vv.mesh, ("Lagrange", 1))
        uv = mod.Function(Vv, np.random.default_rng(2).standard_normal(Vv.num_dofs), **_kw(pkg))
        p = mod.Function(Q, np.random.default_rng(3).standard_normal(Q.num_dofs), **_kw(pkg))
        F0 = mod.LinearForm(Vv, lambda v, c: (1.0 + 0.05 * F.dot(c["u"].value, c["u"].value))
                            * F.inner(F.grad(c["u"]), F.grad(v)) - F.div(v) * F.conj(c["p"].value),
                            coefficients={"u": uv, "p": p})
        J = [mod.derivative(R, "u"), mod.derivative(F0, "u"), mod.derivative(F0, "p")]
        assert J[2].trial_space is Q and J[1].trial_space is Vv
        mats[pkg] = [mod.assemble_matrix(j, None, **_kw(pkg)).to_scipy() for j in J]
    for got, ref in zip(mats["pt"], mats["jx"]):
        assert np.array_equal(got.indices, ref.indices) and _close(got, ref)


# -- NonlinearProblem ------------------------------------------------------


def _nonlinear_poisson(pkg):
    mod, F, _, _ = PKGS[pkg]
    V, bc, mpc = _periodic(pkg, 8)
    u = mod.Function(V, name="u", **_kw(pkg))
    R = mod.LinearForm(V, lambda v, c: F.inner((1 + c["u"].value ** 2) * F.grad(c["u"]), F.grad(v)) - 4.0 * v.value,
                       coefficients={"u": u})
    return V, u, mod.NonlinearProblem(R, u, mpc, bcs=[bc])


def test_newton_nonlinear_poisson_periodic():
    """Newton on -div((1 + u^2) grad u) = 4, periodic in x: converged in
    the JAX package's count, periodic, and equal to its solution."""
    out = {}
    for pkg in PKGS:
        V, u, prob = _nonlinear_poisson(pkg)
        its, converged = prob.solve()
        assert converged and its < 10
        arr = _np(u.x.array)
        coords = V.dof_coords_blocks
        lft = np.flatnonzero(np.isclose(coords[:, 0], 0.0))
        rgt = np.flatnonzero(np.isclose(coords[:, 0], 1.0))
        ls, rs = lft[np.argsort(coords[lft, 1])], rgt[np.argsort(coords[rgt, 1])]
        assert np.abs(arr[ls] - arr[rs]).max() < 1e-9 and arr.max() > 0.1
        out[pkg] = (its, arr)
    assert out["pt"][0] == out["jx"][0]
    assert np.abs(out["pt"][1] - out["jx"][1]).max() <= 1e-10


def test_newton_matches_linear_on_linear_problem():
    """Newton on a linear residual converges to the LinearProblem solution."""
    mod, F = pt, pf
    V = mod.functionspace(pm.create_unit_square(5, 5), ("Lagrange", 1))
    bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
    mpc = mod.MultiPointConstraint(V, device="cpu")
    mpc.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 1.0]).tobytes(): 0.5}})
    mpc.finalize()
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))
    L = mod.LinearForm(V, lambda v, c: 1.0 * v.value)
    u_lin = mod.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-13}).solve()
    u = mod.Function(V, name="u", device="cpu")
    R = mod.LinearForm(V, lambda v, c: F.inner(F.grad(c["u"]), F.grad(v)) + c["u"].value * v.value - 1.0 * v.value,
                       coefficients={"u": u})
    its, converged = mod.NonlinearProblem(R, u, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-13}).solve()
    assert converged and its <= 3
    assert np.abs(u.x.array.numpy() - u_lin.x.array.numpy()).max() < 1e-8


def _arctan_problem(pkg, line_search):
    """Pointwise arctan residual from u0 = 2: full-step Newton diverges,
    backtracking converges to u = 0."""
    mod, F, M, _ = PKGS[pkg]
    V = mod.functionspace(M.create_unit_square(4, 4), ("Lagrange", 1))
    bdofs = mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0))
    bc = mod.dirichletbc(0.0, bdofs, V)
    mpc = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 1.0]).tobytes(): 0.5}})
    mpc.finalize()
    u0 = np.full(V.num_dofs, 2.0)
    u0[bdofs] = 0.0  # bc-compatible start
    u = mod.Function(V, u0, name="u", **_kw(pkg))
    atan = _lib(pkg).arctan
    R = mod.LinearForm(V, lambda v, c: atan(c["u"].value) * v.value, coefficients={"u": u})
    return u, mod.NonlinearProblem(R, u, mpc, bcs=[bc], line_search=line_search, max_it=30, rtol=1e-10, atol=1e-12)


def test_newton_full_step_diverges_backtracking_converges():
    its_f, conv_f = _arctan_problem("pt", "none")[1].solve()
    assert not conv_f and its_f == 30
    u, prob = _arctan_problem("pt", "bt")
    its_bt, conv_bt = prob.solve()
    assert conv_bt and its_bt <= 15
    assert u.x.array.abs().max() < 1e-8


def test_line_search_trials_restart_from_a_snapshot():
    """Every backtracking trial restarts from the iterate's snapshot: the
    trial iterates (read at each residual) equal the JAX package's, and so
    do the Newton count and the solution.  A snapshot that aliases
    u.x.array compounds the trials (u += alpha du on top of the previous
    trial) and breaks all three."""
    runs = {}
    for pkg in PKGS:
        u, prob = _arctan_problem(pkg, "bt")
        trials = []
        residual = prob._residual

        def spy(*a, _res=residual, _u=u, _t=trials):
            _t.append(_np(_u.x.array).copy())
            return _res(*a)

        prob._residual = spy
        its, conv = prob.solve()
        runs[pkg] = (its, conv, trials, _np(u.x.array))
    (its, conv, trials, u), (its_j, conv_j, trials_j, u_j) = runs["pt"], runs["jx"]
    assert conv and conv_j and its == its_j
    assert len(trials) == len(trials_j) > its  # one residual per full step, more: a step was cut back
    for t, tj in zip(trials, trials_j):
        assert np.abs(t - tj).max() <= 1e-10 * max(np.abs(tj).max(), 1.0)
    assert np.abs(u - u_j).max() <= 1e-10


# -- LinearProblem's P form ------------------------------------------------


def _stokes_pform(pkg):
    """The single-matrix rotated-channel Stokes system (8 x 4) with a
    pressure-mass P form."""
    mod, F, M, U = PKGS[pkg]
    theta = np.pi / 7
    mesh = M.create_rectangle((0, 0), (2.0, 1.0), (8, 4))
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
    P = mod.BilinearForm(W, lambda u, v, c: F.inner(F.grad(u[0]), F.grad(v[0])) + u[1].value * F.conj(v[1].value))
    L = mod.LinearForm(W, lambda v, c: F.inner(0.0 * c.x, v[0]) + 0.0 * v[1].value)
    return a, P, L, mpc, bc


def test_pform_stokes_pressure_mass():
    """The pressure-mass P form changes and improves the GMRES count (Jacobi
    on the saddle-point A has a zero pressure diagonal) and converges to the
    same solution; the count with P equals the JAX package's.  Without P,
    restarted GMRES stalls for thousands of iterations and its count is
    decided by rounding (2,390 here against the JAX package's 2,785 on the
    same matrices to 1e-15), so only the halving is held there."""
    opts = {"ksp_type": "gmres", "pc_type": "jacobi", "ksp_rtol": 1e-10, "ksp_max_it": 20000}
    res = {}
    for pkg in PKGS:
        mod = PKGS[pkg][0]
        a, P, L, mpc, bc = _stokes_pform(pkg)
        p_no = mod.LinearProblem(a, L, mpc, bcs=[bc], petsc_options=opts)
        u_no = _np(p_no.solve().x.array)
        p_P = mod.LinearProblem(a, L, mpc, bcs=[bc], petsc_options=opts, P=P)
        u_P = _np(p_P.solve().x.array)
        assert p_P.its < p_no.its / 2, (p_P.its, p_no.its)
        assert np.abs(u_no - u_P).max() / max(np.abs(u_no).max(), 1.0) < 1e-6
        res[pkg] = (p_no.its, p_P.its, u_P)
    assert res["pt"][1] == res["jx"][1]
    assert np.abs(res["pt"][2] - res["jx"][2]).max() <= 1e-10 * max(np.abs(res["jx"][2]).max(), 1.0)


def test_pform_equal_to_a_is_noop():
    """P spelled as the same bilinear form as a gives the no-P count and
    solution (same preconditioner either way)."""
    V, bc, mpc = _periodic("pt", 8)
    a = pt.BilinearForm(V, lambda u, v, c: pf.inner(pf.grad(u), pf.grad(v)))
    P = pt.BilinearForm(V, lambda u, v, c: pf.inner(pf.grad(u), pf.grad(v)))
    L = pt.LinearForm(V, lambda v, c: 4.0 * v.value)
    p_no = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-10})
    u_no = p_no.solve().x.array.clone()
    p_P = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-10}, P=P)
    u_P = p_P.solve().x.array
    assert p_no.its == p_P.its and p_P._P_mat is not None
    assert (u_no - u_P).abs().max() < 1e-12


# -- NonlinearProblemNest --------------------------------------------------


def _nest_setup(pkg, nx=8, ny=4, theta=np.pi / 7):
    mod, F, M, U = PKGS[pkg]
    mesh = M.create_rectangle((0, 0), (2.0, 1.0), (nx, ny))
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    mesh.points[:] = mesh.points @ R.T
    V = mod.functionspace(mesh, ("Lagrange", 2, (2,)))
    Q = mod.functionspace(mesh, ("Lagrange", 1))
    in_rot = lambda m: (lambda x: m(R.T @ x[:2]))  # noqa: E731
    wall = M.locate_entities_boundary(mesh, 1, in_rot(lambda X: np.isclose(X[1], 0.0) | np.isclose(X[1], 1.0)))
    mt = M.meshtags(mesh, 1, wall, 1)
    g = mod.Function(V, **_kw(pkg))

    def inflow(x):
        X = np.linalg.inv(R) @ x[:2]
        return R @ np.stack([4.0 * X[1] * (1.0 - X[1]), np.zeros_like(X[1])])

    g.interpolate(inflow)
    bc = mod.dirichletbc(g, mod.locate_dofs_geometrical(V, in_rot(lambda X: np.isclose(X[0], 0.0))))
    nh = U.create_normal_approximation(V, mt, 1, **_kw(pkg))
    mpc_v = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc_v.create_slip_constraint(V, (mt, 1), nh, [bc])
    mpc_v.finalize()
    mpc_q = mod.MultiPointConstraint(Q, **_kw(pkg))
    mpc_q.finalize()
    u = mod.Function(V, **_kw(pkg))
    p = mod.Function(Q, **_kw(pkg))
    return mod, F, V, Q, mpc_v, mpc_q, bc, nh, wall, u, p


def _nest_forms(mod, F, V, Q, u, p, eps):
    F0 = mod.LinearForm(V, lambda v, c: (1.0 + eps * F.dot(c["u"].value, c["u"].value))
                        * F.inner(F.grad(c["u"]), F.grad(v)) - F.div(v) * F.conj(c["p"].value),
                        coefficients={"u": u, "p": p})
    F1 = mod.LinearForm(Q, lambda q, c: -F.div(c["u"]) * F.conj(q.value), coefficients={"u": u, "p": p})
    return [F0, F1]


@pytest.mark.parametrize("eps", [0.0, 0.05])
def test_nonlinear_nest(eps):
    """Newton on the nest Stokes residual with viscosity 1 + eps |u|^2:
    eps = 0 converges in one correction to the linear nest solution (1e-6,
    tests/test_nonlinear_nest.py), eps = 0.05 in 2-15 steps with slip
    holding; counts and solutions equal the JAX package's (1e-10)."""
    import scipy.sparse.linalg as spla

    res = {}
    for pkg in PKGS:
        mod, F, V, Q, mpc_v, mpc_q, bc, nh, wall, u, p = _nest_setup(pkg)
        prob = mod.NonlinearProblemNest(
            _nest_forms(mod, F, V, Q, u, p, eps), [u, p], [mpc_v, mpc_q], bcs=[bc], u_names=["u", "p"],
            petsc_options={"ksp_type": "gmres", "ksp_rtol": 1e-12, "ksp_max_it": 20000},
            rtol=1e-10 if eps == 0.0 else 1e-9, atol=1e-9, max_it=50 if eps == 0.0 else 20)
        its, converged = prob.solve()
        assert converged
        uv = _np(u.x.array)
        res[pkg] = (its, uv, _np(p.x.array))
        if pkg == "jx":
            continue
        if eps == 0.0:
            assert its <= 3
            a00 = pt.BilinearForm(V, lambda du, v, c: pf.inner(pf.grad(du), pf.grad(v)))
            a01 = pt.BilinearForm(V, lambda dp, v, c: -pf.div(v) * pf.conj(dp.value), V_trial=Q)
            a10 = pt.BilinearForm(Q, lambda du, q, c: -pf.div(du) * pf.conj(q.value), V_trial=V)
            A = pt.create_matrix_nest([[a00, a01], [a10, None]], [mpc_v, mpc_q])
            pt.assemble_matrix_nest(A, [[a00, a01], [a10, None]], [mpc_v, mpc_q], bcs=[bc])
            L0 = pt.LinearForm(V, lambda v, c: pf.inner(0.0 * c.x, v))
            L1 = pt.LinearForm(Q, lambda q, c: 0.0 * q.value)
            b = pt.create_vector_nest([L0, L1], [mpc_v, mpc_q])
            pt.assemble_vector_nest(b, [L0, L1], [mpc_v, mpc_q])
            b0 = pt.set_bc(pt.apply_lifting(b.parts[0], [a00], [[bc]], mpc_v), [bc])
            b1 = pt.apply_lifting(b.parts[1], [a10], [[bc]], mpc_q)
            x = spla.spsolve(A.to_scipy().tocsc(), torch.cat([b0, b1]).numpy())
            u_ref = mpc_v.finalized.backsubstitution(A.split(torch.as_tensor(x))[0]).numpy()
            assert np.abs(uv - u_ref).max() < 1e-6
        else:
            assert 2 <= its <= 15
            nv = nh.x.array.numpy().reshape(-1, 2)
            wb = pt.locate_dofs_topological(V, 1, wall)
            assert np.abs((uv.reshape(-1, 2)[wb] * nv[wb]).sum(1)).max() < 1e-8
            assert np.abs(uv).max() > 0.1
    assert res["pt"][0] == res["jx"][0]
    for got, ref in zip(res["pt"][1:], res["jx"][1:]):
        assert np.abs(got - ref).max() <= 1e-10 * max(np.abs(ref).max(), 1.0)
