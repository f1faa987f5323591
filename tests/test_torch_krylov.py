"""Parity of the port's Krylov methods, preconditioners and eigensolver with
the JAX package: la/solvers.py (cg, bicgstab, gmres, the Jacobi and
Chebyshev preconditioners, SolverOptions and solve's dispatch) and
la/eig.py (eigsh_shift_invert with its batched CG and M-orthonormalization).

Mirrors tests/test_solvers.py and tests/test_eig.py on the same inputs
(float64; cg_segmented is not carried).  The Chebyshev power iteration of
both packages starts from one numpy-seeded probe (the JAX package's default
draws from jax.random, which the port cannot reproduce).  Tolerances: in
float64 the iteration counts are equal, iterates agree to 1e-10 relative
to their largest entry and to 1e-7 against scipy's direct solve; the
Chebyshev operator to 1e-12 relative; eigenvalues to 1e-8 relative against
the JAX package and scipy's eigsh.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.la import solvers as js
from dolfinx_mpc_tpu.la.eig import eigsh_shift_invert as jx_eigsh
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.la import eig as pe, solvers as ps

PKGS = {"jx": (jx, jf, jm), "pt": (pt, pf, pm)}


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


def _system(pkg):
    """tests/test_solvers.py's system: P1 on an 8 x 8 square, Dirichlet at
    y=0, periodic in x, grad-grad plus mass."""
    mod, F, M = PKGS[pkg]
    V = mod.functionspace(M.create_unit_square(8, 8), ("Lagrange", 1))
    bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
    mpc = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))
    return mod.assemble_matrix(a, mpc, bcs=[bc], **_kw(pkg))


@pytest.fixture(scope="module")
def systems():
    Aj, Ap = _system("jx"), _system("pt")
    b = np.random.default_rng(2).standard_normal(Aj.shape[0])
    x_ref = spla.spsolve(Ap.to_scipy().tocsc(), b)
    return Aj, Ap, b, x_ref


def _agree(xp, xj, rel=1e-10):
    xj = np.asarray(xj)
    return np.abs(xp.numpy() - xj).max() <= rel * np.abs(xj).max()


@pytest.mark.parametrize("ksp", ["cg", "bcgs", "gmres"])
def test_ksp_types_match_jax(systems, ksp):
    """solve() dispatch with Jacobi: the JAX package's count and iterate."""
    import jax.numpy as jnp

    Aj, Ap, b, x_ref = systems
    popts = {"ksp_type": ksp, "ksp_rtol": 1e-12, "ksp_max_it": 5000}
    xj, ij, _ = js.solve(Aj.matvec, jnp.asarray(b), js.SolverOptions.from_petsc(popts), diag=Aj.diagonal())
    xp, ip, rp = ps.solve(Ap.matvec, torch.as_tensor(b), ps.SolverOptions.from_petsc(popts), diag=Ap.diagonal())
    assert ip == int(ij) and ip > 1 and isinstance(rp, float)
    assert _agree(xp, xj)
    assert np.abs(xp.numpy() - x_ref).max() < 1e-7


@pytest.mark.parametrize("ksp", ["bcgs", "gmres"])
@pytest.mark.parametrize("pc", ["none", "jacobi", "chebyshev"])
def test_bicgstab_gmres_match_jax(systems, ksp, pc):
    """bicgstab / gmres with each preconditioner, the same probe for the
    Chebyshev power iteration: equal counts, iterates to 1e-10, final
    residual norms to 1e-12 |b|."""
    import jax.numpy as jnp

    Aj, Ap, b, _ = systems
    probe = np.random.default_rng(5).standard_normal(b.shape[0])
    Mj = {"none": None, "jacobi": js.jacobi_preconditioner(Aj.diagonal()),
          "chebyshev": js.chebyshev_preconditioner(Aj.matvec, Aj.diagonal(), probe=jnp.asarray(probe))}[pc]
    Mp = {"none": None, "jacobi": ps.jacobi_preconditioner(Ap.diagonal()),
          "chebyshev": ps.chebyshev_preconditioner(Ap.matvec, Ap.diagonal(), probe=probe)}[pc]
    fj, fp = {"bcgs": (js.bicgstab, ps.bicgstab), "gmres": (js.gmres, ps.gmres)}[ksp]
    xj, ij, rj = fj(Aj.matvec, jnp.asarray(b), M=Mj, rtol=1e-12, max_it=5000)
    xp, ip, rp = fp(Ap.matvec, torch.as_tensor(b), M=Mp, rtol=1e-12, max_it=5000)
    assert ip == int(ij) and ip > 1
    assert _agree(xp, xj)
    assert abs(rp - float(rj)) <= 1e-12 * np.linalg.norm(b)


@pytest.mark.parametrize("restart", [5, 25])
def test_gmres_restart_matches_jax(systems, restart):
    """Restarted GMRES(m): the count over all cycles (a cycle may end past
    max_it) and the iterate equal the JAX package's, also when max_it cuts
    the run short; GMRES(25) converges, GMRES(5) stalls in 2000 its in
    both packages."""
    import jax.numpy as jnp

    Aj, Ap, b, x_ref = systems
    for max_it in (2000, 37):
        xj, ij, rj = js.gmres(Aj.matvec, jnp.asarray(b), M=js.jacobi_preconditioner(Aj.diagonal()), rtol=1e-12,
                              restart=restart, max_it=max_it)
        xp, ip, rp = ps.gmres(Ap.matvec, torch.as_tensor(b), M=ps.jacobi_preconditioner(Ap.diagonal()), rtol=1e-12,
                              restart=restart, max_it=max_it)
        assert ip == int(ij) and _agree(xp, xj)
        assert abs(rp - float(rj)) <= 1e-12 * np.linalg.norm(b)
    if restart == 25:
        assert rp < 1e-9 * np.linalg.norm(b) + 1e-10
        assert np.abs(xp.numpy() - x_ref).max() < 1e-7


def test_bicgstab_restarts_after_breakdown():
    """A 3 x 3 system whose shadow residual is exactly orthogonal to the
    second residual ((r^, r_1) = 0, rows 0 of A and columns 0 cancel): the
    JAX package's bicgstab returns NaN there, counted as converged (the
    defect in ROADMAP queue 3); the port restarts from its iterate with
    r^ = r and solves the system to 1e-12."""
    import jax.numpy as jnp

    A = np.array([[2.0, 1.0, 1.0], [1.0, 3.0, 0.0], [-1.0, 0.0, 4.0]])
    b = np.array([1.0, 0.0, 0.0])
    xj, _, rj = js.bicgstab(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=1e-12)
    assert np.isnan(np.asarray(xj)).all() and np.isnan(float(rj))
    At = torch.as_tensor(A)
    x, its, rn = ps.bicgstab(lambda v: At @ v, torch.as_tensor(b), rtol=1e-12)
    assert np.abs(x.numpy() - np.linalg.solve(A, b)).max() < 1e-12 and rn < 1e-12 and its <= 6


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_bicgstab_undoes_a_nonfinite_step(systems, bad):
    """An operator whose sixth product (the third step's first) comes back
    non-finite, as a near-breakdown that overflows leaves the recurrences:
    the iterate of that step is non-finite, and a loop that tests only
    |r| > tol would return it as converged.  The port undoes the step,
    restarts from the iterate before it and solves the system: x finite,
    to 1e-7 against scipy's direct solve, |r| below rtol |b| = 1e-12 |b|."""
    _, Ap, b, x_ref = systems
    calls = [0]

    def A(v):
        calls[0] += 1
        y = Ap.matvec(v)
        return y * bad if calls[0] == 6 else y

    bt = torch.as_tensor(b)
    x, its, rn = ps.bicgstab(A, bt, M=ps.jacobi_preconditioner(Ap.diagonal()), rtol=1e-12)
    assert calls[0] > 7 and its > 3 and bool(torch.isfinite(x).all())
    assert rn <= 1e-12 * float(torch.linalg.vector_norm(bt))
    assert np.abs(x.numpy() - x_ref).max() < 1e-7


def test_bicgstab_raises_when_a_restart_cannot_step():
    """The rotation [[0, -1], [1, 0]] with b = e0: (r^, A p) = 0 in the
    first step, so its step length overflows.  The JAX package's bicgstab
    returns a NaN iterate there, counted as converged; the port raises
    FloatingPointError (its restart from the start would fail the same
    way) instead of returning a non-finite x."""
    import jax.numpy as jnp

    A = np.array([[0.0, -1.0], [1.0, 0.0]])
    b = np.array([1.0, 0.0])
    xj, kj, _ = js.bicgstab(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), rtol=1e-12)
    assert np.isnan(np.asarray(xj)).any() and int(kj) < 10000
    At = torch.as_tensor(A)
    with pytest.raises(FloatingPointError, match="non-finite"):
        ps.bicgstab(lambda v: At @ v, torch.as_tensor(b), rtol=1e-12)


def test_chebyshev_preconditioner_matches_jax(systems):
    """The Chebyshev operator equals the JAX package's for the same probe
    (degrees 1, 3 and 5), and as a CG preconditioner it cuts the outer
    count against unpreconditioned CG (tests/test_solvers.py)."""
    import jax.numpy as jnp

    Aj, Ap, b, x_ref = systems
    probe = np.random.default_rng(7).standard_normal(b.shape[0])
    r = np.random.default_rng(8).standard_normal(b.shape[0])
    for degree, lmin_frac in ((1, 0.06), (3, 0.06), (5, 0.03)):
        Mj = js.chebyshev_preconditioner(Aj.matvec, Aj.diagonal(), degree=degree, lmin_frac=lmin_frac,
                                         probe=jnp.asarray(probe))
        Mp = ps.chebyshev_preconditioner(Ap.matvec, Ap.diagonal(), degree=degree, lmin_frac=lmin_frac, probe=probe)
        assert _agree(Mp(torch.as_tensor(r)), Mj(jnp.asarray(r)), 1e-12)
    x, its_c, _ = ps.cg(Ap.matvec, torch.as_tensor(b), M=Mp, rtol=1e-12, max_it=5000)
    _, its_0, _ = ps.cg(Ap.matvec, torch.as_tensor(b), rtol=1e-12, max_it=5000)
    assert np.abs(x.numpy() - x_ref).max() < 1e-7 and its_c < its_0


def test_chebyshev_default_probe_is_seeded(systems):
    """Without a probe the power iteration starts from a torch.Generator
    seeded 0 (float64 standard normals, cast): the same operator on every
    call, and solve() passes SolverOptions.cheb_probe through."""
    _, Ap, b, _ = systems
    d = Ap.diagonal()
    p0 = ps.default_probe(d.shape, torch.float64, "cpu")
    assert torch.equal(p0, torch.randn(d.shape, generator=torch.Generator().manual_seed(0), dtype=torch.float64))
    r = torch.as_tensor(b)
    y1 = ps.chebyshev_preconditioner(Ap.matvec, d)(r)
    assert torch.equal(y1, ps.chebyshev_preconditioner(Ap.matvec, d)(r))
    assert torch.equal(y1, ps.chebyshev_preconditioner(Ap.matvec, d, probe=p0.numpy())(r))
    opts = ps.SolverOptions(ksp_type="bcgs", pc_type="chebyshev", rtol=1e-10)
    x1, i1, _ = ps.solve(Ap.matvec, r, opts, diag=d)
    opts.cheb_probe = np.random.default_rng(1).standard_normal(b.shape[0])
    x2, i2, _ = ps.solve(Ap.matvec, r, opts, diag=d)
    assert i1 > 1 and i2 > 1 and not torch.equal(x1, x2)


def test_options_from_petsc_defaults():
    o = ps.SolverOptions.from_petsc(None)
    assert (o.ksp_type, o.pc_type, o.cheb_degree, o.cheb_probe) == ("cg", "jacobi", 3, None)
    o2 = ps.SolverOptions.from_petsc({"pc_type": "none", "ksp_rtol": "1e-4"})
    assert o2.pc_type == "none" and o2.rtol == 1e-4
    oj = js.SolverOptions.from_petsc({"pc_type": "none", "ksp_rtol": "1e-4"})
    assert (oj.ksp_type, oj.pc_type, oj.rtol, oj.atol, oj.max_it, oj.cheb_degree) == (
        o2.ksp_type, o2.pc_type, o2.rtol, o2.atol, o2.max_it, o2.cheb_degree)


def test_unknown_types_raise(systems):
    _, Ap, b, _ = systems
    r = torch.as_tensor(b)
    for opts, match in ((ps.SolverOptions(ksp_type="minres"), "ksp_type"),
                        (ps.SolverOptions(ksp_type="preonly"), "preonly"),
                        (ps.SolverOptions(pc_type="ilu"), "pc_type")):
        with pytest.raises(ValueError, match=match):
            ps.solve(Ap.matvec, r, opts, diag=Ap.diagonal())


def _pencil(pkg):
    """tests/test_eig.py's pencil: P1 on a 10 x 10 square, Dirichlet at
    y=0/1, periodic in x, stiffness (diagval 1e4) and mass (diagval 1)."""
    mod, F, M = PKGS[pkg]
    V = mod.functionspace(M.create_unit_square(10, 10), ("Lagrange", 1))
    bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = mod.MultiPointConstraint(V, **_kw(pkg))
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    k_form = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)))
    m_form = mod.BilinearForm(V, lambda u, v, c: F.inner(u, v))
    K = mod.assemble_matrix(k_form, mpc, bcs=[bc], diagval=1e4, **_kw(pkg))
    Mm = mod.assemble_matrix(m_form, mpc, bcs=[bc], diagval=1.0, **_kw(pkg))
    return V, mpc, bc, k_form, m_form, K, Mm


def test_eigsh_shift_invert_poisson_pencil():
    """The smallest eigenvalues of the constrained pencil: equal to the JAX
    package's and to scipy's eigsh on the reduced free pencil to 1e-8
    relative, with the JAX package's outer and inner counts, and the
    eigenvector residuals ||K u - lam M u|| / lam below 1e-7."""
    import jax.numpy as jnp

    from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix

    nev = 3
    _, _, _, _, _, Kj, Mj = _pencil("jx")
    lam_j, _, info_j = jx_eigsh(Kj, Mj, nev, sigma=0.0, pc=js.jacobi_preconditioner(jnp.asarray(Kj.diagonal())),
                                tol=1e-9)
    V, mpc, bc, k_form, m_form, K, Mm = _pencil("pt")
    lam_u, U, info = pe.eigsh_shift_invert(K, Mm, nev, sigma=0.0, pc=ps.jacobi_preconditioner(K.diagonal()),
                                           tol=1e-9)
    lam = np.sort(lam_u)
    assert np.allclose(lam, np.sort(np.asarray(lam_j)), rtol=1e-8, atol=0)
    assert (info["outer"], info["inner"]) == (info_j["outer"], info_j["inner"])
    Ks = pt.assemble_matrix(k_form, None, bcs=[bc], device="cpu").to_scipy()
    Ms = pt.assemble_matrix(m_form, None, bcs=[bc], device="cpu").to_scipy()
    Kt = gather_transformation_matrix(mpc)
    is_slave = np.zeros(V.num_dofs, bool)
    is_slave[mpc.slaves] = True
    red = -np.ones(V.num_dofs, np.int64)
    red[~is_slave] = np.arange((~is_slave).sum())
    free = red[np.setdiff1d(np.flatnonzero(~is_slave), bc.dofs)]
    Kr = (Kt.T @ Ks @ Kt).tocsr()[free][:, free]
    Mr = (Kt.T @ Ms @ Kt).tocsr()[free][:, free]
    vals = np.sort(spla.eigsh(Kr, k=nev, M=Mr, sigma=0, which="LM", return_eigenvectors=False))
    assert np.allclose(lam, vals, rtol=1e-8, atol=0)
    for i in range(nev):
        u = U[:, i].contiguous()
        r = K.matvec(u) - Mm.matvec(u) * float(lam_u[i])
        assert float(torch.linalg.vector_norm(r)) / lam_u[i] < 1e-7


def test_eigsh_shift_invert_nonzero_sigma():
    """sigma below the spectrum of a diagonal pencil (plain callables, a
    start block X0): the eigenvalues nearest sigma, equal to the JAX
    package's with its outer count; the inner (batched CG) count within 1 %
    of its (the block's rounding moves when a column freezes)."""
    import jax.numpy as jnp

    n = 200
    rng = np.random.default_rng(3)
    d = np.sort(rng.uniform(1.0, 100.0, n))
    m = rng.uniform(0.5, 2.0, n)
    X0 = rng.standard_normal((n, 8))
    lam_j, _, info_j = jx_eigsh(lambda x: jnp.asarray(d) * m * x, lambda x: jnp.asarray(m) * x, 4, sigma=0.5,
                                X0=jnp.asarray(X0), tol=1e-9)
    dt, mt = torch.as_tensor(d), torch.as_tensor(m)
    lam, U, info = pe.eigsh_shift_invert(lambda x: dt * mt * x, lambda x: mt * x, 4, sigma=0.5, X0=X0, tol=1e-9,
                                         device="cpu")
    want = d[np.argsort(np.abs(d - 0.5))[:4]]
    assert np.allclose(np.sort(lam), np.sort(want), rtol=1e-7)
    assert np.allclose(np.sort(lam), np.sort(np.asarray(lam_j)), rtol=1e-8, atol=0)
    assert info["outer"] == info_j["outer"] and abs(info["inner"] - info_j["inner"]) <= 0.01 * info_j["inner"]
    assert tuple(U.shape) == (n, 4)


def test_block_products_equal_column_products(systems):
    """The eigensolver's column-block products: CSRMatrix.matmat and
    JacobiPC.matmat equal their matvecs column by column, and an operator
    without matmat (here a BELL matrix) is applied one column at a time."""
    from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy

    _, Ap, b, _ = systems
    X = torch.as_tensor(np.random.default_rng(9).standard_normal((b.shape[0], 4)))
    cols = lambda mv: torch.stack([mv(X[:, j].contiguous()) for j in range(4)], dim=1)  # noqa: E731
    assert torch.allclose(Ap.matmat(X), cols(Ap.matvec), rtol=1e-14, atol=1e-14)
    J = ps.jacobi_preconditioner(Ap.diagonal())
    assert torch.equal(J.matmat(X), cols(J))
    B = bell_from_scipy(Ap.to_scipy(), dtype=np.float64, device="cpu")
    assert torch.allclose(pe._block(B)(X), Ap.matmat(X), rtol=1e-13, atol=1e-13)


def test_eigsh_float32_defaults():
    """In float32 the default tolerances are 2e-4 (outer) and 1e-6 (inner):
    the pencil's eigenvalues to 1e-4 relative of the float64 ones."""
    _, _, _, _, _, K, Mm = _pencil("pt")
    lam64, _, _ = pe.eigsh_shift_invert(K, Mm, 3, pc=ps.jacobi_preconditioner(K.diagonal()))
    from dolfinx_mpc_tpu_torch.la.sparse import CSRMatrix

    f32 = lambda A: CSRMatrix(A.data.float(), A.indices, A.indptr, A.row_ids, A.shape)  # noqa: E731
    K32, M32 = f32(K), f32(Mm)
    lam32, U32, info = pe.eigsh_shift_invert(K32, M32, 3, pc=ps.jacobi_preconditioner(K32.diagonal()))
    assert U32.dtype == torch.float32 and info["outer"] < 40
    assert np.allclose(np.sort(lam32), np.sort(lam64), rtol=1e-4)


def test_eigsh_start_block_follows_the_operator(monkeypatch):
    """Without X0 the start block takes the device and dtype of the
    operators: a MatrixFreeKTAK on the CPU (no .data tensor, its own
    .device and .dtype) gives the CSR pencil's eigenvalues to 1e-8
    relative, with its vectors on the CPU.  Plain callables with a numpy
    X0 and no `device` go to the port's default device, the card: without
    one that raises, naming device='cpu'."""
    from dolfinx_mpc_tpu_torch.ops.matfree import MatrixFreeKTAK

    _, mpc, bc, k_form, _, K, Mm = _pencil("pt")
    lam, _, _ = pe.eigsh_shift_invert(K, Mm, 3, pc=ps.jacobi_preconditioner(K.diagonal()), tol=1e-9)
    op = MatrixFreeKTAK(k_form, mpc, bcs=[bc], diagval=1e4)
    lam_mf, U, _ = pe.eigsh_shift_invert(op, Mm, 3, pc=ps.jacobi_preconditioner(op.diagonal()), tol=1e-9)
    assert U.device.type == "cpu" and U.dtype == torch.float64
    assert np.allclose(np.sort(lam_mf), np.sort(lam), rtol=1e-8, atol=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pe.eigsh_shift_invert(lambda x: 2.0 * x, lambda x: x, 2, X0=np.eye(6)[:, :4])
