"""Parity of the port's tied-contact path with the JAX package: the contact
MPC (constraints.py), the general slot-CSR assembler (ops/assemble.py),
the rigid-body near-nullspace (utils/mpc_utils.py), smoothed-aggregation
AMG (la/amg.py) and the BELL + AMG + CG solve of
benchmarks/bench_contact_3D.py --format bell --pc amg, at small sizes.

The problem is the benchmark's: two P1 vector tet boxes of NB^3 and NT^3
cells stacked at z=1, tied by create_contact_inelastic_condition(mt, 1, 2),
Dirichlet 0 at z=0 and (0, 0, -0.05) at z=2, 2 mu sym(grad u):sym(grad v) +
lambda div u div v with mu=1, lambda=1.25; here with a body force so that b
is nonzero away from the top plane.  Tolerances: host numpy code (constraint
tables, patterns, AMG set-up on the same scipy input) must be equal;
assembled values 1e-12 relative (another summation order); solutions 1e-10
against the JAX package and 1e-8 against the oracle K (K^T A K)^-1 K^T b
(tests/conftest.py:42-45).
"""

import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.la.amg import smoothed_aggregation_amg as jx_amg
from dolfinx_mpc_tpu.la.bell import bell_from_scipy as jx_bell
from dolfinx_mpc_tpu.la.solvers import cg as jx_cg
from dolfinx_mpc_tpu.utils.mpc_utils import rigid_motions_nullspace as jx_rigid
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg as pt_amg
from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy as pt_bell
from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix
from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace as pt_rigid

PKGS = {"jx": (jx, jf, jm), "pt": (pt, pf, pm)}
SIZES = [(4, 3), (6, 5)]


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


@functools.lru_cache(maxsize=None)
def _contact(pkg, nb, nt, dtype=np.float64):
    """(V, mpc, bcs, a, L) of the stacked-cubes tied-contact problem."""
    mod, F, M = PKGS[pkg]
    bot = M.create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = M.create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = M.Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                  bot.cell_type)
    V = mod.functionspace(mesh, ("Lagrange", 1, (3,)))
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts][:, :, 2], 1.0).all(axis=1)
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(on_iface & ext)
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    mt = M.meshtags(mesh, 2, iface, np.where(cz > 1.0, 1, 2))
    mpc = mod.MultiPointConstraint(V, dtype, **_kw(pkg))
    mpc.create_contact_inelastic_condition(mt, 1, 2)
    mpc.finalize()
    bc = mod.dirichletbc(np.zeros(3), mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V)
    bct = mod.dirichletbc(np.array([0.0, 0.0, -0.05]),
                          mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 2.0)), V)
    a = mod.BilinearForm(V, lambda u, v, c: 2.0 * F.inner(F.sym(F.grad(u)), F.sym(F.grad(v)))
                         + 1.25 * F.div(u) * F.conj(F.div(v)))
    L = mod.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0]
                       + 0.5 * c.x[1] * v.value[..., 1] - v.value[..., 2])
    return V, mpc, [bc, bct], a, L


@functools.lru_cache(maxsize=None)
def _jx_system(nb, nt):
    """The JAX package's constrained scipy A and b (float64)."""
    V, mpc, bcs, a, L = _contact("jx", nb, nt)
    A = jx.assemble_matrix(a, mpc, bcs=bcs).to_scipy()
    b = jx.set_bc(jx.apply_lifting(jx.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
    return A, np.asarray(b)


def _pt_system(nb, nt):
    V, mpc, bcs, a, L = _contact("pt", nb, nt)
    A = pt.assemble_matrix(a, mpc, bcs=bcs)
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
    return A, b


def _oracle(nb, nt):
    """u = K (K^T A K)^-1 K^T b, with the unconstrained A from the port's own
    general assembler (float64, CPU)."""
    V, mpc, bcs, a, L = _contact("pt", nb, nt)
    A = pt.assemble_matrix(a, None, bcs, device="cpu").to_scipy()
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [bcs], None), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    return K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("nb,nt", SIZES)
def test_contact_tables_equal_jax(nb, nt):
    _, mj, _, _, _ = _contact("jx", nb, nt)
    _, mp, _, _, _ = _contact("pt", nb, nt)
    assert mp.num_local_slaves == mj.num_local_slaves > 0
    assert np.array_equal(mp.slaves, mj.slaves)
    for got, ref in ((mp.masters, mj.masters), (mp.coefficients, mj.coefficients)):
        for g, r in zip(got, ref):  # flat values and offsets
            assert np.array_equal(g, np.asarray(r))
    assert np.array_equal(mp._np_masters, np.asarray(mj._np_masters))
    assert np.array_equal(mp._np_coeffs, np.asarray(mj._np_coeffs))


@pytest.mark.parametrize("nb,nt", SIZES)
def test_assemble_matrix_contact_matches_jax(nb, nt):
    Aj, bj = _jx_system(nb, nt)
    Ap, bp = _pt_system(nb, nt)
    assert isinstance(Ap, pt.ops.assemble.MPCMatrix) and Ap.data.dtype == torch.float64
    S = Ap.to_scipy()
    assert np.array_equal(S.indptr, Aj.indptr) and np.array_equal(S.indices, Aj.indices)
    assert abs(S - Aj).max() < 1e-12 * abs(Aj).max()
    assert _rel(bp.numpy(), bj) < 1e-12
    # the unconstrained matrix (the oracle's) too
    _, _, bcs_j, a_j, _ = _contact("jx", nb, nt)
    _, _, bcs_p, a_p, _ = _contact("pt", nb, nt)
    A0j = jx.assemble_matrix(a_j, None, bcs=bcs_j, dtype=np.float64).to_scipy()
    A0p = pt.assemble_matrix(a_p, None, bcs_p, device="cpu").to_scipy()
    assert abs(A0p - A0j).max() < 1e-12 * abs(A0j).max()


@pytest.mark.parametrize("cell_type", ["triangle", "quadrilateral"])
@pytest.mark.parametrize("degree", [1, 2])
def test_assemble_matrix_periodic_2d_matches_jax(cell_type, degree):
    """2-D Poisson with a periodic MPC (the shape of
    tests/test_matrix_assembly.py:43), through the general assembler."""
    out = {}
    for pkg, (mod, F, M) in PKGS.items():
        V = mod.functionspace(M.create_unit_square(4, 4, cell_type), ("Lagrange", degree))
        bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
        mpc = mod.MultiPointConstraint(V, np.float64, **_kw(pkg))
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
        mpc.finalize()
        a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)))
        out[pkg] = mod.assemble_matrix(a, mpc, bcs=[bc], diagval=3.5).to_scipy()
    assert np.array_equal(out["pt"].indptr, out["jx"].indptr)
    assert abs(out["pt"] - out["jx"]).max() < 1e-12 * abs(out["jx"]).max()


@pytest.mark.parametrize("nb,nt", SIZES)
def test_sparsity_pattern_equal_jax(nb, nt):
    _, mj, _, aj, _ = _contact("jx", nb, nt)
    _, mp, _, ap, _ = _contact("pt", nb, nt)
    pj = jx.create_sparsity_pattern(aj, mj)
    pp = pt.create_sparsity_pattern(ap, mp)
    for name in ("indptr", "indices", "row_ids"):
        assert np.array_equal(getattr(pp, name), getattr(pj, name)), name
    assert len(pp.slots) == len(pj.slots)
    assert all(np.array_equal(s, r) for s, r in zip(pp.slots, pj.slots))


def test_chunked_assembly_matches_single_shot(monkeypatch):
    """Assembling 7 cells at a time equals the single-shot assembly (the
    chunk bounds the per-quadrature intermediates), and the JAX package's
    chunked assembly (tests/test_matrix_assembly.py:112)."""
    from dolfinx_mpc_tpu_torch.ops import assemble as pt_assemble

    V, mpc, bcs, a, _ = _contact("pt", 4, 3)
    one = pt.assemble_matrix(a, mpc, bcs)
    monkeypatch.setattr(pt_assemble, "CELL_CHUNK", 7)
    chunked = pt.assemble_matrix(a, mpc, bcs)
    assert torch.equal(one.data, chunked.data)
    Aj, _ = _jx_system(4, 3)
    assert abs(chunked.to_scipy() - Aj).max() < 1e-12 * abs(Aj).max()


def test_rigid_motions_nullspace_equal():
    Vj = _contact("jx", 4, 3)[0]
    Vp = _contact("pt", 4, 3)[0]
    Nj, Np_ = jx_rigid(Vj), pt_rigid(Vp)
    assert Np_.shape == (Vp.num_dofs, 6)
    assert np.array_equal(Np_, Nj)


def test_amg_hierarchy_equal_jax():
    """On the same scipy matrix both packages build the same hierarchy bit
    for bit (host set-up copied, same seeds); one V-cycle agrees to 1e-12."""
    A, _ = _jx_system(6, 5)
    Vj = _contact("jx", 6, 5)[0]
    ns = jx_rigid(Vj)
    Mj = jx_amg(A, bs=3, dtype=np.float64, nullspace=ns, coarse_size=200)
    Mp = pt_amg(A, bs=3, dtype=np.float64, nullspace=ns, coarse_size=200, device="cpu")
    assert len(Mp.Ps) == len(Mj.Ps) >= 2
    assert [o.shape for o in Mp.ops] == [tuple(o.shape) for o in Mj.ops]
    assert Mp.cheb == list(Mj.cheb)
    for mats_p, mats_j in ((Mp.Ps, Mj.Ps), (Mp.Rs, Mj.Rs)):
        for P, Q in zip(mats_p, mats_j):
            S, T = P.to_scipy(), Q.to_scipy()
            assert np.array_equal(S.indptr, T.indptr) and np.array_equal(S.indices, T.indices)
            assert np.array_equal(S.data, T.data)
    assert np.array_equal(Mp.coarse_inv.numpy(), np.asarray(Mj.coarse_inv))
    r = np.random.default_rng(0).standard_normal(A.shape[0])
    assert _rel(Mp(torch.as_tensor(r)).numpy(), np.asarray(Mj(jnp.asarray(r)))) < 1e-12


@pytest.mark.parametrize("nb,nt", SIZES)
def test_bell_amg_cg_matches_jax_and_oracle(nb, nt):
    """The benchmark's solve (BELL operator, SA-AMG with the rigid modes,
    CG), in float64: the JAX iteration count, the JAX solution within
    1e-10 and the oracle within 1e-8."""
    Aj, bj = _jx_system(nb, nt)
    Vj, mj, _, _, _ = _contact("jx", nb, nt)
    Bj = jx_bell(Aj, dtype=np.float64)
    Mj = jx_amg(Aj, bs=3, dtype=np.float64, nullspace=jx_rigid(Vj))
    xj, its_j, _ = jx_cg(Bj.matvec, jnp.asarray(bj), M=Mj, rtol=1e-12, atol=0.0, max_it=500)
    uj = np.asarray(mj.finalized.backsubstitution(xj))

    Ap, bp = _pt_system(nb, nt)
    Vp, mp, _, _, _ = _contact("pt", nb, nt)
    As = Ap.to_scipy()
    Bp = pt_bell(As, dtype=np.float64, device="cpu")
    Mp = pt_amg(As, bs=3, dtype=np.float64, nullspace=pt_rigid(Vp), device="cpu")
    xp, its_p, _ = pt.cg(Bp.matvec, bp, M=Mp, rtol=1e-12, atol=0.0, max_it=500)
    up = mp.finalized.backsubstitution(xp).numpy()
    assert its_p == int(its_j)
    assert _rel(up, uj) < 1e-10
    assert np.abs(up - _oracle(nb, nt)).max() < 1e-8


def test_bell_amg_cg_float32_counts_match_jax():
    """The benchmark's float32 recipe (constraint and assembly in float64,
    BELL, AMG, b and CG in float32, rtol 1e-6) gives the JAX package's CPU
    iteration count."""
    Aj, bj = _jx_system(6, 5)
    Vj = _contact("jx", 6, 5)[0]
    Mj = jx_amg(Aj, bs=3, dtype=np.float32, nullspace=jx_rigid(Vj))
    _, its_j, _ = jx_cg(jx_bell(Aj, dtype=np.float32).matvec, jnp.asarray(bj, jnp.float32), M=Mj, rtol=1e-6)
    Ap, bp = _pt_system(6, 5)
    As = Ap.to_scipy()
    Mp = pt_amg(As, bs=3, dtype=np.float32, nullspace=pt_rigid(_contact("pt", 6, 5)[0]), device="cpu")
    _, its_p, _ = pt.cg(pt_bell(As, dtype=np.float32, device="cpu").matvec, bp.to(torch.float32), M=Mp, rtol=1e-6)
    assert its_p == int(its_j)


def test_linear_problem_gamg_contact_matches_jax_and_oracle():
    """LinearProblem with ksp cg / pc gamg on the contact mesh (no lattice):
    the general assembler, the rigid modes attached to AMG; same its and
    solution as the JAX package (tests/test_amg.py:204), oracle 1e-8."""
    opts = {"ksp_type": "cg", "pc_type": "gamg", "ksp_rtol": 1e-12}
    res = {}
    for pkg in PKGS:
        V, mpc, bcs, a, L = _contact(pkg, 6, 5)
        prob = PKGS[pkg][0].LinearProblem(a, L, mpc, bcs=bcs, petsc_options=opts)
        u = prob.solve().x.array
        res[pkg] = (np.asarray(u) if pkg == "jx" else u.numpy(), prob.its)
    assert res["pt"][1] == res["jx"][1]
    assert _rel(res["pt"][0], res["jx"][0]) < 1e-10
    assert np.abs(res["pt"][0] - _oracle(6, 5)).max() < 1e-8


def test_solve_amg_needs_the_operator():
    """The AMG pc types need the assembled operator and say so (the JAX
    package warns and falls back to Jacobi; the port does not fall back)."""
    from dolfinx_mpc_tpu_torch.la.solvers import SolverOptions, solve

    opts = SolverOptions.from_petsc({"pc_type": "gamg"})
    with pytest.raises(ValueError, match="assembled operator"):
        solve(lambda v: v, torch.ones(4, dtype=torch.float64), opts, diag=torch.ones(4, dtype=torch.float64))


@pytest.mark.parametrize("dtype,tol,mt_cap", [(np.float64, 1e-13, None), (np.float32, 5e-6, None),
                                              (np.float64, 1e-13, 4), (np.float32, 5e-6, 4)])
def test_bell_packed_contact_operator_matches_jax(dtype, tol, mt_cap):
    """K8's packed layout of the contact operator at NB=4/NT=3 (and with a
    4-tile budget, which spills the MPC rows' far couplings to the
    remainder): every nonzero once (exact against to_scipy), and its plain
    SpMV against the JAX package's BellMatrix.matvec and its Pallas kernel
    in interpret mode + the remainder's segment_sum (f32)."""
    import jax

    from dolfinx_mpc_tpu.la.bell import _bell_matvec_pallas
    from dolfinx_mpc_tpu_torch.la.bell import bell_matvec, bell_packed_matvec_plain

    Ap, _ = _pt_system(4, 3)
    As = Ap.to_scipy()
    kw = {} if mt_cap is None else {"mt_cap": mt_cap}
    Bj = jx_bell(As, dtype=dtype, **kw)
    Bp = pt_bell(As, dtype=dtype, device="cpu", **kw)
    P = Bp.pack()
    S = Bp.to_scipy()
    S.eliminate_zeros()
    assert abs(P.to_scipy() - S).max() == 0 and P.nnz == S.nnz
    if mt_cap is not None:
        assert Bp.rem_data.shape[0] > 0
    x = np.random.default_rng(4).standard_normal(As.shape[1]).astype(dtype)
    got = bell_matvec(Bp, torch.as_tensor(x)).numpy()
    assert np.array_equal(got, bell_packed_matvec_plain(P, torch.as_tensor(x)).numpy())
    assert np.linalg.norm(got - np.asarray(Bj.matvec(jnp.asarray(x)))) <= tol * np.linalg.norm(got)
    if dtype == np.float32:
        nblk, mt, R, C = Bj.data.shape
        x2 = Bj._x_tiles(jnp.asarray(x))
        y = _bell_matvec_pallas(nblk, mt, R, C, x2.shape[0], interpret=True)(Bj.cols, Bj.data, x2)
        y = y.reshape(-1)[:Bj.shape[0]]
        if Bj.rem_data.shape[0]:
            y = y + jax.ops.segment_sum(Bj.rem_data * jnp.asarray(x)[Bj.rem_cols], Bj.rem_rows,
                                        num_segments=Bj.shape[0], indices_are_sorted=True)
        assert np.linalg.norm(got - np.asarray(y)) <= tol * np.linalg.norm(got)


def test_packed_bell_cg_float32_counts_match_jax():
    """The float32 recipe of test_bell_amg_cg_float32_counts_match_jax with
    every matvec through K8's plain version on the packed layout (the sum
    order of the card's path): the JAX package's CPU iteration count."""
    from dolfinx_mpc_tpu_torch.la.bell import bell_matvec

    Aj, bj = _jx_system(6, 5)
    Vj = _contact("jx", 6, 5)[0]
    Mj = jx_amg(Aj, bs=3, dtype=np.float32, nullspace=jx_rigid(Vj))
    _, its_j, _ = jx_cg(jx_bell(Aj, dtype=np.float32).matvec, jnp.asarray(bj, jnp.float32), M=Mj, rtol=1e-6)
    Ap, bp = _pt_system(6, 5)
    As = Ap.to_scipy()
    Mp = pt_amg(As, bs=3, dtype=np.float32, nullspace=pt_rigid(_contact("pt", 6, 5)[0]), device="cpu")
    Bp = pt_bell(As, dtype=np.float32, device="cpu")
    Bp.pack()
    _, its_p, _ = pt.cg(lambda v: bell_matvec(Bp, v), bp.to(torch.float32), M=Mp, rtol=1e-6)
    assert its_p == int(its_j)
