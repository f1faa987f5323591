"""The bs=3 elasticity slice and the unmasked assembler: the plain versions
of K1 at bs=3, K7 (vector DIA SpMV), K5 (unmasked assembler, on the vertex
grid, the blocked class grids and the refined degree-2 grid) and K3 at
bs=3, the bs=3 fold operator and its interop, GMG-CG at bs=3, LinearProblem
with a vector source and the Dirichlet-free oracles.  Held against the JAX
package on the same inputs: its Pallas kernels in interpret mode (float32,
the tolerances of tests/test_pallas_lattice.py) and its XLA paths
(float64)."""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as JF
from dolfinx_mpc_tpu.fem.mesh import create_box as jx_box
from dolfinx_mpc_tpu.la.gmg import LatticeGMG as JGMG, build_gmg_hierarchy as jx_hier
from dolfinx_mpc_tpu.la.solvers import cg as jx_cg
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu.ops.pallas_lattice import (
    make_dia_matvec_bs_pallas,
    make_lean_blocked_pallas,
    make_lean_fold_pallas,
)
from dolfinx_mpc_tpu_torch.fem import forms as PF
from dolfinx_mpc_tpu_torch.fem.mesh import create_box as pt_box
from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
from dolfinx_mpc_tpu_torch.ops.lattice import assemble_matrix_lattice as pt_lattice
from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix
from dolfinx_mpc_tpu_torch.utils.interop import dia_from_numpy, fold_operator_from_numpy

PKGS = {"jx": (jx, jx_box, JF, jx_lattice), "pt": (pt, pt_box, PF, pt_lattice)}


def _y_planes(x):
    return np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)


def _ball(x):
    """Non-separable and clear of the periodic planes x=0/1: the y-planes
    and a ball about (0.5, 0, 0.5)."""
    return _y_planes(x) | ((x[0] - 0.5) ** 2 + x[1] ** 2 + (x[2] - 0.5) ** 2 < 0.35 ** 2)


def _elasticity(F):
    """bench.py's bs=3 form (mu = 1, lambda = 1.25, quad_degree 1)."""
    return (lambda u, v, c: 2.0 * F.inner(F.sym(F.grad(u)), F.sym(F.grad(v)))
            + 1.25 * F.div(u) * F.conj(F.div(v)))


def _reaction(F):
    """The constant-M form of tests/test_pallas_lattice.py:114-118."""
    return lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + 0.5 * F.inner(u, v)


def _problem(pkg, dims, degree=1, bs=1, marker=_y_planes, dtype=np.float64):
    """(V, bcs, mpc, a): periodic in x, Dirichlet zero on `marker` (none
    when None); elasticity for bs=3, the reaction-diffusion form for bs=1."""
    mod, box, F, _ = PKGS[pkg]
    V = mod.functionspace(box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims),
                          ("Lagrange", degree, (bs,)) if bs > 1 else ("Lagrange", degree))
    bcs = [] if marker is None else [
        mod.dirichletbc(np.zeros(bs) if bs > 1 else 0.0, mod.locate_dofs_geometrical(V, marker), V)]
    mpc = mod.MultiPointConstraint(V, dtype)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), bcs)
    mpc.finalize()
    if bs > 1:
        a = mod.BilinearForm(V, _elasticity(F), quad_degree=1)
    else:
        a = mod.BilinearForm(V, _reaction(F), quad_degree=degree + 1)
    return V, bcs, mpc, a


@functools.lru_cache(maxsize=None)
def _clf(pkg, dims, degree=1, bs=1, marker=_y_planes, dtype=np.float64):
    _, bcs, mpc, a = _problem(pkg, dims, degree, bs, marker, dtype)
    kw = {"device": "cpu"} if pkg == "pt" else {}
    return PKGS[pkg][3](a, mpc, bcs=bcs, dtype=dtype, side_format="fold", **kw)


def _rel_max(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


# ---------------------------------------------------------------------------
# K1 at bs=3 and K3 at bs=3
# ---------------------------------------------------------------------------


def test_k1_and_k5_bs3_plain_match_pallas_interpret_f32():
    """K1's plain version at bs=3 against the JAX package's unmasked Pallas
    kernel plus its grid masking passes (test_pallas_bs3_assembler_matches_xla),
    and K5's plain version, on the raw table of the same form, against that
    unmasked kernel alone."""
    import jax.numpy as jnp

    cj = _clf("jx", (4, 4, 4), bs=3, dtype=np.float32)
    cp = _clf("pt", (4, 4, 4), bs=3, dtype=np.float32)
    assert cp.offsets == cj.offsets and cp.bs == 3 and cp.table.factors is not None
    n0, n1, n2 = cp.vshape
    dv = jnp.float32(1.7)
    raw_ref = np.asarray(make_lean_fold_pallas(cj, interpret=True)(jnp.float32(0.021)))
    raw = jnp.asarray(raw_ref).reshape(len(cj.offsets), 3, 3, n0, n1, n2)
    ref = np.asarray(cj._diag_adds(cj._zero_bc_on_grid(raw, cj._keep_grid), dv))
    got = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float32), 0.021, 1.7)
    assert got.dtype == torch.float32 and got.shape == (135, n0, n1, n2)
    assert _rel_max(got.numpy().reshape(ref.shape), ref) < 5e-6
    raw_got = LK.assemble_fold_lean_raw(LK.build_fold_table(cp).on("cpu", torch.float32), 0.021)
    assert _rel_max(raw_got.numpy(), raw_ref) < 5e-6


@pytest.mark.parametrize("jitter", [0.0, -0.2])
def test_k1_bs3_plain_matches_xla_lean_f64(jitter):
    import jax.numpy as jnp

    cj, cp = _clf("jx", (3, 4, 5), bs=3), _clf("pt", (3, 4, 5), bs=3)
    ref = np.asarray(cj._assemble_fold_lean(jnp.float64(jitter), jnp.float64(1.0), cj._keep_grid).dia.data)
    got = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float64), jitter, 1.0)
    assert _rel_max(got.numpy().reshape(ref.shape), ref) < 1e-12
    # the diagval term lands on the ci == cj diagonal planes of offset 0 only
    zid = cp.offsets.index((0, 0, 0))
    diag_rows = [r for r in cp.table.planes if r[5]]
    assert [(r[0], r[1], r[2], r[3], r[4]) for r in diag_rows] == [(c, c, 0, 0, 0) for c in range(3)]
    assert all(cp.table.planes[(zid * 3 + ci) * 3 + cj][5] == (ci == cj) for ci in range(3) for cj in range(3))


def test_k3_bs3_nonseparable_set():
    """A non-separable Dirichlet set at bs=3 goes to K3's plain version; it
    equals the JAX package's XLA masking and the port's own masking passes
    on unmasked planes."""
    import jax.numpy as jnp

    cj, cp = _clf("jx", (4, 4, 4), bs=3, marker=_ball), _clf("pt", (4, 4, 4), bs=3, marker=_ball)
    assert cp.table.factors is None and cp.table.keep is not None and cp.table.keep.shape[0] == 3
    n = LK.assemble_fold_lean_masked.launches
    A = cp.assemble()
    assert LK.assemble_fold_lean_masked.launches == n  # CPU: the plain version
    ref = np.asarray(cj._assemble_fold_lean(jnp.float64(0.0), jnp.float64(1.0), cj._keep_grid).dia.data)
    assert _rel_max(A.dia.data.numpy(), ref) < 1e-12
    raw_tab = dataclasses.replace(cp.table, keep=np.ones_like(cp.table.keep),
                                  bc_ind=np.zeros_like(cp.table.bc_ind), _on={})
    raw = LK.assemble_fold_lean_masked_plain(raw_tab.on("cpu", torch.float64), 0.0, 1.0)
    masked = cp._diag_adds(cp._zero_bc_on_grid(raw.reshape(A.dia.data.shape),
                                               torch.as_tensor(cp._keep_grid)), 1.0)
    assert torch.equal(A.dia.data, masked)


# ---------------------------------------------------------------------------
# K7: vector DIA SpMV
# ---------------------------------------------------------------------------


def test_k7_plain_matches_pallas_interpret_f32():
    """DIAMatrix.matvec at bs=3 on the CPU (K7's plain version) against the
    JAX package's bs>1 Pallas SpMV (test_pallas_bs3_matvec_matches)."""
    import jax.numpy as jnp

    dia = _clf("jx", (4, 4, 4), bs=3, dtype=np.float32).assemble().dia
    x = np.random.default_rng(3).standard_normal(dia.shape[0]).astype(np.float32)
    ref = np.asarray(make_dia_matvec_bs_pallas(dia.offsets, dia.vshape, 3, interpret=True)(
        dia.data, jnp.asarray(x)))
    dp = dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.vshape, 3)
    n7 = LK.dia_matvec_bs.launches
    got = dp.matvec(torch.as_tensor(x))
    assert LK.dia_matvec_bs.launches == n7
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() < 5e-6 * max(np.abs(ref).max(), 1.0)
    assert torch.equal(got, LK.dia_matvec_bs(dp.data, dp.offsets, dp.vshape, 3, torch.as_tensor(x)))


def test_k7_plain_matches_xla_f64_and_refuses_other_devices():
    import jax.numpy as jnp

    dia = _clf("jx", (3, 4, 5), bs=3).assemble().dia
    x = np.random.default_rng(4).standard_normal(dia.shape[0])
    ref = np.asarray(dia.matvec(jnp.asarray(x)))
    dp = dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.vshape, 3)
    assert _rel_l2(dp.matvec(torch.as_tensor(x)).numpy(), ref) < 1e-13
    with pytest.raises(RuntimeError):
        LK.dia_matvec_bs(dp.data.to("meta"), dp.offsets, dp.vshape, 3, torch.as_tensor(x).to("meta"))


# ---------------------------------------------------------------------------
# K5: the unmasked assembler
# ---------------------------------------------------------------------------

# (layout, degree, bs): the vertex grid at bs 1 and 3, the blocked class
# grids and the refined grid (r = 2) of degree 2
K5_CASES = [("grid", 1, 1), ("grid", 1, 3), ("blocked", 2, 1), ("refined", 2, 1)]
# the bs=3 vertex-grid case against Pallas is in
# test_k1_and_k5_bs3_plain_match_pallas_interpret_f32
K5_PALLAS_CASES = [c for c in K5_CASES if c != ("grid", 1, 3)]


def _k5_table(cp, layout):
    return LK.build_fold_table(cp, _refined=True) if layout == "refined" else cp.table


@pytest.mark.parametrize("layout,degree,bs", K5_PALLAS_CASES)
def test_k5_plain_matches_pallas_interpret_f32(layout, degree, bs):
    """K5's plain version against make_lean_fold_pallas(clf, interpret=True)
    at r=1 and at r=2 (test_pallas_degree_and_reaction[2]),
    and make_lean_blocked_pallas on the blocked view, all unmasked."""
    import jax.numpy as jnp

    cj = _clf("jx", (3, 3, 3), degree, bs, marker=None, dtype=np.float32)
    cp = _clf("pt", (3, 3, 3), degree, bs, marker=None, dtype=np.float32)
    assert cp.table.factors is None and cp.table.keep is None
    make = make_lean_blocked_pallas if layout == "blocked" else make_lean_fold_pallas
    ref = np.asarray(make(cj, interpret=True)(jnp.float32(0.02)))
    tab = _k5_table(cp, layout)
    assert tab.refine == (2 if layout == "refined" else 1) and tab.blocked == (layout == "blocked")
    got = LK.assemble_fold_lean_raw(tab.on("cpu", torch.float32), 0.02)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_max(got.numpy(), ref) < 5e-6


@pytest.mark.parametrize("layout,degree,bs", K5_CASES[:3])
def test_k5_equals_unit_factor_k1_k4_and_xla(layout, degree, bs):
    """A form without Dirichlet dofs assembles through K5's raw table: the
    result equals K1 / K4 with unit mask factors bit for bit (the dispatch
    the port had before K5) and the JAX package's XLA lean path."""
    import jax.numpy as jnp

    cj = _clf("jx", (3, 4, 5), degree, bs, marker=None)
    cp = _clf("pt", (3, 4, 5), degree, bs, marker=None)
    if layout == "blocked":
        keep, ind, pads = cp._keep_blocked, cp._bc_ind_blocked, cp._blocked_pads()
    else:
        keep, ind, pads = cp._keep_grid, cp._bc_ind_grid, None
    factors = LK._detect_factored_masks(keep, ind, pads)
    assert factors is not None
    unit = LK.build_fold_table(cp, factors, keep, ind).on("cpu", torch.float64)
    raw = LK.assemble_fold_lean_raw(cp.table.on("cpu", torch.float64), 0.013)
    assert torch.equal(raw, LK.assemble_fold_lean_factored_plain(unit, 0.013, 2.3))
    A = cp._assemble_fold_lean_kernel(0.013, 2.3)
    if layout == "blocked":
        ref = cj._assemble_fold_lean_blocked(jnp.float64(0.013), jnp.float64(2.3), cj._keep_blocked)
    else:
        ref = cj._assemble_fold_lean(jnp.float64(0.013), jnp.float64(2.3), cj._keep_grid)
    assert _rel_max(A.dia.data.numpy(), np.asarray(ref.dia.data)) < 1e-12
    assert torch.equal(A.dia.data.reshape(raw.shape), raw)


def test_k5_refuses_masked_refined_table():
    cp = _clf("pt", (3, 3, 3), 2, 1, marker=None)
    with pytest.raises(ValueError, match="raw"):
        LK.build_fold_table(cp, cp.table.factors, keep=np.ones((1,) + cp.vshape), _refined=True)
    tab = LK.build_fold_table(cp, _refined=True)
    assert tab.vshape == cp.vshape and tab.n_planes == len(cp.offsets) == 65
    with pytest.raises(RuntimeError):
        LK.assemble_fold_lean_raw(tab.on("meta", torch.float32), 0.0)


# ---------------------------------------------------------------------------
# the bs=3 operator, interop, GMG and LinearProblem
# ---------------------------------------------------------------------------


def test_elasticity_operator_matches_jax_and_scipy():
    """The bs=3 fold operator: matvec, diagonal and to_scipy equal the JAX
    package's, on its own data (interop) and on the port's assembly, and
    to_scipy reproduces the matvec (test_pallas_bs3_oracle)."""
    import jax.numpy as jnp

    Aj = _clf("jx", (3, 4, 5), bs=3).assemble()
    Ap = _clf("pt", (3, 4, 5), bs=3).assemble()
    Ai = fold_operator_from_numpy(
        dia_from_numpy(np.asarray(Aj.dia.data), Aj.dia.offsets, Aj.dia.vshape, 3),
        Aj.fold_axis, np.asarray(Aj.fold_mask), Aj.diagval, fold_pairs=Aj.fold_pairs)
    assert Ai.dia.bs == 3 and Ai.fold_mask.shape == Ap.fold_mask.shape == (5, 6, 3)
    x = np.random.default_rng(7).standard_normal(Aj.shape[0])
    y_ref = np.asarray(Aj.matvec(jnp.asarray(x)))
    S_ref = Aj.to_scipy()
    for A in (Ai, Ap):
        assert _rel_l2(A.matvec(torch.as_tensor(x)).numpy(), y_ref) < 1e-13
        assert _rel_max(A.diagonal().numpy(), np.asarray(Aj.diagonal())) < 1e-13
        S = A.to_scipy()
        assert abs(S - S_ref).max() < 1e-13 * abs(S_ref).max()
        assert _rel_l2(S @ x, y_ref) < 1e-13


def test_oracle_matrix_bs3_matches_jax():
    """assemble_matrix_scipy on the unrolled (nd * bs) element tensors of a
    bs=3 space equals the JAX package's general assembler."""
    Vj, bcj, _, aj = _problem("jx", (3, 3, 3), bs=3)
    Vp, bcp, _, ap = _problem("pt", (3, 3, 3), bs=3)
    Aj = jx.assemble_matrix(aj, None, bcs=bcj, dtype=np.float64).to_scipy()
    Ap = assemble_matrix_scipy(ap, bcp)
    assert Ap.shape == (192, 192)
    assert abs(Ap - Aj).max() < 1e-13 * abs(Aj).max()


def _manufactured_b(pkg, clf, A):
    """bench.py:504-515 for bs > 1: b = A u0, u0 the sin pattern times
    keep, interleaved (float32)."""
    n0, n1, n2 = clf.vshape
    ax = [np.arange(m, dtype=np.float32) / m for m in (n0, n1, n2)]
    pat = (np.sin(np.pi * ax[0])[:, None, None] * np.sin(np.pi * ax[1])[None, :, None]
           * np.sin(2 * np.pi * ax[2])[None, None, :])
    u0 = np.moveaxis(pat[None] * np.asarray(clf._keep_grid), 0, -1).reshape(-1).astype(np.float32)
    if pkg == "pt":
        return A.matvec(torch.as_tensor(u0))
    import jax.numpy as jnp

    return A.matvec(jnp.asarray(u0))


@functools.lru_cache(maxsize=None)
def _bench_clf(pkg, m):
    return _clf(pkg, (m, m, m), bs=3, dtype=np.float32)


@pytest.mark.parametrize("n,min_n", [(8, 4), (16, 8)])
def test_gmg_cg_bs3_matches_jax_f32(n, min_n):
    """bench.py's BENCH_BS=3 solve (Chebyshev 3+3 GMG-CG to rtol 1e-6,
    manufactured b) in float32: the same CG iteration count as the JAX
    package (10 at n=16) and solutions within 1e-5."""
    oj, mj = jx_hier(functools.partial(_bench_clf, "jx"), n, 4, min_n=min_n)
    op, mp = pt.build_gmg_hierarchy(functools.partial(_bench_clf, "pt"), n, 4, min_n=min_n)
    assert [o.dia.vshape for o in op] == [o.dia.vshape for o in oj] and len(op) >= 2
    assert all(o.dia.bs == 3 and o.dtype == torch.float32 for o in op)
    kw = dict(smoother="chebyshev", n_pre=3, n_post=3)
    Mj, Mp = JGMG(oj, free_masks=mj, **kw), pt.LatticeGMG(op, free_masks=mp, **kw)
    assert np.allclose(Mp._bounds, Mj._bounds, rtol=1e-5)
    bj = _manufactured_b("jx", _bench_clf("jx", n), oj[0])
    bp = _manufactured_b("pt", _bench_clf("pt", n), op[0])
    assert _rel_l2(bp.numpy(), np.asarray(bj)) < 1e-5
    xj, its_j, _ = jx_cg(oj[0].matvec, bj, M=Mj, rtol=1e-6, atol=1e-12, max_it=3000)
    xp, its_p, _ = pt.cg(op[0].matvec, bp, M=Mp, rtol=1e-6, atol=1e-12, max_it=3000)
    assert its_p == int(its_j)
    if n == 16:
        assert its_p == 10
    assert _rel_l2(xp.numpy(), np.asarray(xj)) < 1e-5


def _vector_source(v, c):
    """A vector source (1 + x z, y / 2, -1) tested against v."""
    x = c.x
    return (1.0 + x[0] * x[2]) * v.value[..., 0] + 0.5 * x[1] * v.value[..., 1] - v.value[..., 2]


def _oracle(V, bcs, mpc, a, L):
    A = assemble_matrix_scipy(a, bcs)
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None), [a], [bcs], None), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    return K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)


def test_linear_problem_bs3_meets_oracle():
    """LinearProblem through the lattice dispatch at bs=3 (vector source,
    vector bc value np.zeros(3)) in f64 against K (K^T A K)^-1 K^T b, with
    the JAX package's iteration count; a second solve reuses the
    value-keyed operator."""
    V, bcs, mpc, a = _problem("pt", (4, 4, 4), bs=3)
    L = pt.LinearForm(V, _vector_source)
    opts = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12}
    prob = pt.LinearProblem(a, L, mpc, bcs=bcs, petsc_options=opts)
    u = prob.solve().x.array.numpy()
    assert np.abs(u - _oracle(V, bcs, mpc, a, L)).max() < 1e-8
    Vj, bcj, mpcj, aj = _problem("jx", (4, 4, 4), bs=3)
    pj = jx.LinearProblem(aj, jx.LinearForm(Vj, _vector_source), mpcj, bcs=bcj, petsc_options=opts)
    pj.solve()
    assert prob.its == pj.its
    n_cached = len(a._compiled_cache)
    prob.solve()
    assert len(a._compiled_cache) == n_cached


@pytest.mark.parametrize("degree,n", [(1, 6), (2, 3)])
def test_dirichlet_free_oracles(degree, n):
    """The reaction-diffusion form without Dirichlet dofs, periodic in x:
    LinearProblem assembles through K5's raw table (then K2 / K6 in the
    solve) and meets the oracle in f64."""
    V, bcs, mpc, a = _problem("pt", (n, n, n), degree, marker=None)
    L = pt.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0] * c.x[2]) * v.value)
    prob = pt.LinearProblem(a, L, mpc, bcs=bcs,
                            petsc_options={"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12})
    u = prob.solve().x.array.numpy()
    (clf,) = a._compiled_cache.values()
    assert clf.table.factors is None and clf.table.keep is None
    assert np.abs(u - _oracle(V, bcs, mpc, a, L)).max() < 1e-8
