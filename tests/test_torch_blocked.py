"""The degree-2 slice: the parity-blocked operator (BlockDIAMatrix, the
blocked fold LatticeOperator), the plain versions of K4 (blocked assembler),
K6 (blocked SpMV) and K3 (masked assembler, both layouts), GMG with
blocked_io over the p-coarsened level list, and LinearProblem at degree 2.
Held against the JAX package on the same inputs: its Pallas kernels in
interpret mode (float32, the tolerances of tests/test_pallas_lattice.py) and
its XLA paths (float64)."""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem.forms import grad as jgrad, inner as jinner
from dolfinx_mpc_tpu.fem.mesh import create_box as jx_box
from dolfinx_mpc_tpu.la.gmg import LatticeGMG as JGMG, build_gmg_hierarchy as jx_hier
from dolfinx_mpc_tpu.la.solvers import cg as jx_cg
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu.ops.pallas_lattice import (
    _BlockedView,
    _detect_factored_masks as jx_detect,
    make_blocked_matvec_pallas,
    make_lean_blocked_pallas,
    make_lean_fold_pallas,
)
from dolfinx_mpc_tpu_torch.fem.forms import grad as pgrad, inner as pinner
from dolfinx_mpc_tpu_torch.fem.mesh import create_box as pt_box
from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, assemble_matrix_lattice as pt_lattice
from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix
from dolfinx_mpc_tpu_torch.utils.interop import block_dia_from_numpy, fold_operator_from_numpy

DIMS = [(3, 3, 3), (3, 4, 5)]


def _y_planes(x):
    return np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)


def _blob(x):
    """Non-separable: the y-planes and a corner blob (the set of
    tests/test_pallas_lattice.py:403-404 with the y-planes)."""
    return _y_planes(x) | ((x[0] + x[1] + x[2]) < 0.35)


def _ball(x):
    """Non-separable and clear of the periodic planes x=0/1: the y-planes
    and a ball about (0.5, 0, 0.5)."""
    return _y_planes(x) | ((x[0] - 0.5) ** 2 + x[1] ** 2 + (x[2] - 0.5) ** 2 < 0.35 ** 2)


def _new_mpc(pkg, V, dtype):
    """pkg.MultiPointConstraint(V, dtype), on the CPU for the port (its
    entry points default to the card)."""
    return pkg.MultiPointConstraint(V, dtype, **({"device": "cpu"} if pkg is pt else {}))


def _problem(pkg, box, gradf, innerf, dims, degree, dtype, marker=_y_planes):
    mesh = box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims)
    V = pkg.functionspace(mesh, ("Lagrange", degree))
    bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(V, marker), V)
    mpc = _new_mpc(pkg, V, dtype)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pkg.BilinearForm(V, lambda u, v, c: innerf(gradf(u), gradf(v)), quad_degree=degree)
    L = pkg.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0] * c.x[2]) * v.value)
    return V, bc, mpc, a, L


@functools.lru_cache(maxsize=None)
def _jx_clf(dims, degree, dtype, marker=_y_planes):
    V, bc, mpc, a, _ = _problem(jx, jx_box, jgrad, jinner, dims, degree, dtype, marker)
    return jx_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold")


@functools.lru_cache(maxsize=None)
def _pt_clf(dims, degree, dtype, marker=_y_planes):
    V, bc, mpc, a, _ = _problem(pt, pt_box, pgrad, pinner, dims, degree, dtype, marker)
    return pt_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold", device="cpu")


def _rel_max(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("dims", DIMS)
def test_blocked_structure_equals_jax(dims):
    cj, cp = _jx_clf(dims, 2, np.float64), _pt_clf(dims, 2, np.float64)
    assert cp.trips == cj.trips and len(cp.trips) == 230
    assert [t[0][0] for t in cp.trips] == sorted(t[0][0] for t in cp.trips)
    assert cp._bmoves == [(t, a, b, m, tuple(int(v) for v in sh)) for t, a, b, m, sh in cj._bmoves]
    assert cp._cdims == cj._cdims and cp._classes == cj._classes
    assert np.array_equal(cp._keep_blocked, np.asarray(cj._keep_blocked))
    assert np.array_equal(cp._bc_ind_blocked, np.asarray(cj._bc_ind_blocked))
    assert np.array_equal(cp._fold_mask_blocked.numpy(), np.asarray(cj._fold_mask_blocked))
    assert np.array_equal(cp._keep_grid, np.asarray(cj._keep_grid))
    # the default P2 path takes K4's factored form, as in the JAX package
    assert jx_detect(_BlockedView(_jx_clf(dims, 2, np.float32))) == "factored"
    assert cp.table.factors is not None and cp.table.blocked and cp.table.vshape == cp._cdims


def test_k4_plain_matches_pallas_interpret_f32():
    import jax.numpy as jnp

    cj, cp = _jx_clf((3, 3, 3), 2, np.float32), _pt_clf((3, 3, 3), 2, np.float32)
    pal = make_lean_blocked_pallas(cj, interpret=True, fuse_mask=True)
    ref = np.asarray(pal(jnp.float32(0.013), cj._keep_blocked, jnp.float32(1.7), cj._bc_ind_blocked))
    got = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float32), 0.013, 1.7)
    assert got.dtype == torch.float32 and got.shape == (230,) + cp._cdims
    assert _rel_max(got.numpy(), ref) < 5e-6


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("jitter", [0.0, -0.2])
def test_k4_plain_matches_xla_blocked_f64(dims, jitter):
    import jax.numpy as jnp

    cj, cp = _jx_clf(dims, 2, np.float64), _pt_clf(dims, 2, np.float64)
    ref = np.asarray(cj._assemble_fold_lean_blocked(jnp.float64(jitter), jnp.float64(1.0),
                                                    cj._keep_blocked).dia.data)
    got = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float64), jitter, 1.0)
    assert _rel_max(got.numpy(), ref) < 1e-12


def test_k4_fused_masks_equal_blocked_masking_passes():
    """K4's fused masks == unmasked planes + _zero_bc_blocked +
    _diag_adds_blocked, bit for bit; every padded slot is an exact 0."""
    cp = _pt_clf((3, 4, 5), 2, np.float64)
    raw_tab = dataclasses.replace(
        cp.table, factors=tuple(np.ones_like(f) for f in cp.table.factors), _on={})
    raw = LK.assemble_fold_lean_factored_plain(raw_tab.on("cpu", torch.float64), 0.02, 2.3)
    ref = cp._diag_adds_blocked(cp._zero_bc_blocked(raw, torch.as_tensor(cp._keep_blocked)), 2.3)
    fused = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float64), 0.02, 2.3)
    assert torch.equal(fused, ref)
    cid = {c: i for i, c in enumerate(cp._classes)}
    pad = torch.as_tensor(cp._blocked_pads()[0])  # x-axis real slots per class
    for m, (cr, _, _) in enumerate(cp.trips):
        assert not fused[m][pad[cid[cr]] == 0].any()


def test_k6_plain_matches_pallas_interpret_f32():
    import jax.numpy as jnp

    dia = _jx_clf((3, 4, 5), 2, np.float32).assemble().dia
    xb = np.random.default_rng(0).standard_normal((8,) + dia.cdims).astype(np.float32)
    ref = np.asarray(make_blocked_matvec_pallas(dia.trips, dia.vshape, dia.r3, interpret=True)(
        dia.data, jnp.asarray(xb)))
    dp = block_dia_from_numpy(np.asarray(dia.data), dia.trips, dia.vshape, dia.r3, device="cpu")
    got = dp.matvec_blocked(torch.as_tensor(xb))
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), ref) < 5e-6


@pytest.mark.parametrize("dims", DIMS)
def test_k6_plain_matches_xla_f64(dims):
    """On the JAX operator's own data (interop) and on the port's assembled
    operator."""
    import jax.numpy as jnp

    dia = _jx_clf(dims, 2, np.float64).assemble().dia
    xb = np.random.default_rng(1).standard_normal((8,) + dia.cdims)
    ref = np.asarray(dia.matvec_blocked(jnp.asarray(xb)))
    d_int = block_dia_from_numpy(np.asarray(dia.data), dia.trips, dia.vshape, dia.r3, device="cpu")
    d_pt = _pt_clf(dims, 2, np.float64).assemble().dia
    for d in (d_int, d_pt):
        got = LK.blocked_matvec(d.data, d.trips, d.classes, torch.as_tensor(xb))
        assert _rel_l2(got.numpy(), ref) < 1e-13
    x = np.random.default_rng(2).standard_normal(dia.shape[0])
    assert _rel_l2(d_pt.matvec(torch.as_tensor(x)).numpy(), np.asarray(dia.matvec(jnp.asarray(x)))) < 1e-13


@pytest.mark.parametrize("dims", DIMS)
def test_blocked_fold_operator_matches_jax(dims):
    import jax.numpy as jnp

    Aj = _jx_clf(dims, 2, np.float64).assemble()
    Ap = _pt_clf(dims, 2, np.float64).assemble()
    Ai = fold_operator_from_numpy(
        block_dia_from_numpy(np.asarray(Aj.dia.data), Aj.dia.trips, Aj.dia.vshape, Aj.dia.r3, device="cpu"),
        Aj.fold_axis, np.asarray(Aj.fold_mask), Aj.diagval, fold_pairs=Aj.fold_pairs,
        fold_mask_b=np.asarray(Aj.fold_mask_b), device="cpu")
    x = np.random.default_rng(3).standard_normal(Aj.shape[0])
    xb = np.asarray(Aj.dia._to_blocked(jnp.asarray(x)))
    y_ref = np.asarray(Aj.matvec(jnp.asarray(x)))
    yb_ref = np.asarray(Aj.matvec_blocked(jnp.asarray(xb)))
    d_ref, db_ref = np.asarray(Aj.diagonal()), np.asarray(Aj.diagonal_blocked())
    S_ref = Aj.to_scipy()
    for A in (Ai, Ap):
        assert A.supports_blocked()
        assert np.array_equal(A.dia._to_blocked(torch.as_tensor(x)).numpy(), xb)
        assert _rel_l2(A.matvec(torch.as_tensor(x)).numpy(), y_ref) < 1e-13
        assert _rel_l2(A.matvec_blocked(torch.as_tensor(xb)).numpy(), yb_ref) < 1e-13
        assert _rel_max(A.diagonal().numpy(), d_ref) < 1e-13
        assert _rel_max(A.diagonal_blocked().numpy(), db_ref) < 1e-13
        assert abs(A.to_scipy() - S_ref).max() < 1e-13 * abs(S_ref).max()


@pytest.mark.parametrize("degree", [1, 2])
def test_k3_plain_matches_pallas_2d_interpret_f32(degree):
    """A non-separable Dirichlet set: the JAX detection finds no factors, so
    its "2d" masked kernel runs; K3's plain version matches it, on the P1
    grid and the P2 blocked layout."""
    import jax.numpy as jnp

    dims = (4, 4, 4) if degree == 1 else (3, 3, 3)
    cj, cp = _jx_clf(dims, degree, np.float32, _blob), _pt_clf(dims, degree, np.float32, _blob)
    assert cp.table.factors is None and cp.table.blocked == (degree == 2)
    if degree == 1:
        assert jx_detect(cj) is None
        ref = make_lean_fold_pallas(cj, interpret=True, fuse_mask=True)(
            jnp.float32(0.01), cj._keep_grid, jnp.float32(1.3), cj._bc_ind_grid)
    else:
        assert jx_detect(_BlockedView(cj)) is None
        ref = make_lean_blocked_pallas(cj, interpret=True, fuse_mask=True)(
            jnp.float32(0.01), cj._keep_blocked, jnp.float32(1.3), cj._bc_ind_blocked)
    ref = np.asarray(ref)
    got = LK.assemble_fold_lean_masked_plain(cp.table.on("cpu", torch.float32), 0.01, 1.3).numpy()
    assert np.abs(got - ref).max() < 1e-6 * max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("degree", [1, 2])
def test_k3_plain_matches_xla_masking_f64(degree):
    """K3 in float64 against the JAX package's XLA lean path, which masks in
    separate passes; and against the port's own masking passes."""
    import jax.numpy as jnp

    dims = (3, 4, 5)
    cj, cp = _jx_clf(dims, degree, np.float64, _blob), _pt_clf(dims, degree, np.float64, _blob)
    jit, dv = 0.013, 1.7
    if degree == 1:
        ref = cj._assemble_fold_lean(jnp.float64(jit), jnp.float64(dv), cj._keep_grid).dia.data
    else:
        ref = cj._assemble_fold_lean_blocked(jnp.float64(jit), jnp.float64(dv), cj._keep_blocked).dia.data
    ref = np.asarray(ref)
    tab = cp.table.on("cpu", torch.float64)
    got = LK.assemble_fold_lean_masked_plain(tab, jit, dv)
    assert _rel_max(got.numpy().reshape(ref.shape), ref) < 1e-12
    keep = cp.table.keep[:, 1:-1, 1:-1, 1:-1]
    raw_tab = dataclasses.replace(cp.table, keep=np.ones_like(cp.table.keep),
                                  bc_ind=np.zeros_like(cp.table.bc_ind), _on={})
    raw = LK.assemble_fold_lean_masked_plain(raw_tab.on("cpu", torch.float64), jit, dv)
    if degree == 1:
        n0, n1, n2 = cp.vshape
        raw = raw.reshape(len(cp.offsets), 1, 1, n0, n1, n2)
        masked = cp._diag_adds(cp._zero_bc_on_grid(raw, torch.as_tensor(keep)), dv)
    else:
        masked = cp._diag_adds_blocked(cp._zero_bc_blocked(raw, torch.as_tensor(keep)), dv)
    assert torch.equal(got, masked.reshape(got.shape))


def _p_levels(n):
    """bench.py's p-coarsened level list for degree 2 (bench.py:545-550),
    with one h-level below the identity transfer at this small n."""
    levels, m = [(2, n), (1, 2 * n)], n
    while m >= 4 and m % 2 == 0:
        levels.append((1, m))
        m //= 2
    return levels


def _hierarchies(n):
    def mk(pkg, box, gradf, innerf, lattice, kw):
        def make(lv):
            deg, m = lv
            V, bc, mpc, a, _ = _problem(pkg, box, gradf, innerf, (m, m, m), deg, np.float64)
            return lattice(a, mpc, bcs=[bc], dtype=np.float64, side_format="fold", **kw)
        return make

    levels = _p_levels(n)
    oj, mj = jx_hier(mk(jx, jx_box, jgrad, jinner, jx_lattice, {}), n, 0, levels=levels)
    op, mp = pt.build_gmg_hierarchy(mk(pt, pt_box, pgrad, pinner, pt_lattice, dict(device="cpu")),
                                    n, 0, levels=levels)
    return (oj, mj), (op, mp)


def _gmgs(n, blocked_io):
    (oj, mj), (op, mp) = _hierarchies(n)
    kw = dict(blocked_io=blocked_io, smoother="chebyshev", n_pre=2, n_post=2)
    return (oj, JGMG(oj, free_masks=mj, **kw)), (op, pt.LatticeGMG(op, free_masks=mp, **kw))


def _u0(vshape):
    """The manufactured solution of bench.py:504-515 at P2 n=4 (b = A u0)."""
    n0, n1, n2 = vshape
    g = np.meshgrid(np.arange(n0) / n0, np.arange(n1) / n1, np.arange(n2) / n2, indexing="ij")
    keep = _pt_clf((4, 4, 4), 2, np.float64)._keep_grid[0]
    return (np.sin(np.pi * g[0]) * np.sin(np.pi * g[1]) * np.sin(2 * np.pi * g[2]) * keep).reshape(-1)


def test_gmg_blocked_io_vcycle_and_cg_match_jax():
    import jax.numpy as jnp

    (oj, Mj), (op, Mp) = _gmgs(4, blocked_io=True)
    assert [o.dia.vshape for o in op] == [(9, 9, 9), (9, 9, 9), (5, 5, 5)]
    assert np.allclose(Mp._bounds, Mj._bounds, rtol=1e-13)
    assert np.array_equal(Mp.free_masks[0].numpy(), np.asarray(Mj.free_masks[0]))
    r = np.random.default_rng(4).standard_normal(op[0].shape[0])
    rb = np.asarray(oj[0].dia._to_blocked(jnp.asarray(r)))
    vj = np.asarray(Mj(jnp.asarray(rb)))
    vp = Mp(torch.as_tensor(rb)).numpy()
    assert vp.shape == rb.shape and _rel_max(vp, vj) < 1e-10
    # manufactured right-hand side b = A u0 (bench.py:504-515), CG on the
    # class stack
    u0 = _u0(op[0].dia.vshape)
    bj = oj[0].dia._to_blocked(oj[0].matvec(jnp.asarray(u0)))
    bp = op[0].dia._to_blocked(op[0].matvec(torch.as_tensor(u0)))
    assert _rel_max(bp.numpy(), np.asarray(bj)) < 1e-13
    xj, its_j, _ = jx_cg(oj[0].matvec_blocked, bj, M=Mj, rtol=1e-10, atol=1e-14, max_it=200)
    xp, its, _ = pt.cg(op[0].matvec_blocked, bp, M=Mp, rtol=1e-10, atol=1e-14, max_it=200)
    assert its == int(its_j) and its < 20
    assert _rel_max(xp.numpy(), np.asarray(xj)) < 1e-10


def test_gmg_flat_io_over_blocked_fine_level_matches_jax_and_blocked_io():
    """blocked_io=False over the same blocked fine level: flat vectors in
    and out, against the JAX package's flat cycle (tests/test_gmg.py:155-185
    runs it beside blocked I/O); GMG-CG takes the same iterations and
    reaches the same solution as with blocked I/O."""
    import jax.numpy as jnp

    (oj, Mj), (op, Mp) = _gmgs(4, blocked_io=False)
    assert op[0].supports_blocked() and not Mp.blocked_io
    r = np.random.default_rng(5).standard_normal(op[0].shape[0])
    vp = Mp(torch.as_tensor(r)).numpy()
    assert vp.shape == r.shape and _rel_max(vp, np.asarray(Mj(jnp.asarray(r)))) < 1e-10
    b = op[0].matvec(torch.as_tensor(_u0(op[0].dia.vshape)))
    x, its, _ = pt.cg(op[0].matvec, b, M=Mp, rtol=1e-10, atol=1e-14, max_it=200)
    xj, its_j, _ = jx_cg(oj[0].matvec, jnp.asarray(b.numpy()), M=Mj, rtol=1e-10, atol=1e-14, max_it=200)
    assert its == int(its_j) and _rel_max(x.numpy(), np.asarray(xj)) < 1e-10
    Mb = pt.LatticeGMG(op, free_masks=Mp.free_masks, blocked_io=True, smoother="chebyshev",
                       n_pre=2, n_post=2)
    xb, its_b, _ = pt.cg(op[0].matvec_blocked, op[0].dia._to_blocked(b), M=Mb, rtol=1e-10, atol=1e-14,
                         max_it=200)
    assert its_b == its and _rel_max(op[0].dia._from_blocked(xb).numpy(), x.numpy()) < 1e-8


def _oracle(V, bc, mpc, a, L):
    A = assemble_matrix_scipy(a, [bc])
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [[bc]], None), [bc]).numpy()
    K = gather_transformation_matrix(mpc)
    return K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)


OPTS = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12}


@pytest.mark.parametrize("degree,n,marker", [(2, 3, _y_planes), (1, 6, _ball), (2, 3, _ball)])
def test_linear_problem_meets_oracle(degree, n, marker):
    """LinearProblem at degree 2 (K4, K6) and with a non-separable
    Dirichlet set (K3) against u = K (K^T A K)^-1 K^T b, float64."""
    V, bc, mpc, a, L = _problem(pt, pt_box, pgrad, pinner, (n, n, n), degree, np.float64, marker)
    prob = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options=OPTS)
    u = prob.solve().x.array.numpy()
    assert isinstance(prob.A.dia, BlockDIAMatrix) == (degree == 2)
    clf = next(v for k, v in a._compiled_cache.items())
    assert (clf.table.factors is None) == (marker is _ball)
    assert np.abs(u - _oracle(V, bc, mpc, a, L)).max() < 1e-8


def test_linear_problem_dirichlet_masters_match_jax():
    """The corner blob makes three masters of the x-wrap Dirichlet dofs.
    Both packages then fold after masking, so a Dirichlet master row takes
    its slave's row, while the oracle masks after folding: the port agrees
    with the JAX package, not with the oracle (ROADMAP queue 3)."""
    V, bc, mpc, a, L = _problem(pt, pt_box, pgrad, pinner, (6, 6, 6), 1, np.float64, _blob)
    u = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options=OPTS).solve().x.array.numpy()
    Vj, bcj, mpcj, aj, Lj = _problem(jx, jx_box, jgrad, jinner, (6, 6, 6), 1, np.float64, _blob)
    uj = np.asarray(jx.LinearProblem(aj, Lj, mpcj, bcs=[bcj], petsc_options=OPTS).solve().x.array)
    assert np.isin(mpc._np_masters[:, 0], bc.dofs).sum() == 3
    assert np.abs(u - uj).max() < 1e-12 * np.abs(uj).max()
    assert np.abs(u - _oracle(V, bc, mpc, a, L)).max() > 1e-3


def test_blocked_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    """CPU tensors take the plain versions of K3, K4 and K6 and launch
    nothing; a tensor on any other non-CUDA device raises."""
    cp, cm = _pt_clf((3, 3, 3), 2, np.float32), _pt_clf((3, 3, 3), 2, np.float32, _blob)
    counts = lambda: (LK.assemble_fold_lean_blocked.launches,  # noqa: E731
                      LK.assemble_fold_lean_masked.launches, LK.blocked_matvec.launches)
    before = counts()
    A = cp.assemble()
    assert torch.equal(A.dia.data, LK.assemble_fold_lean_factored_plain(
        cp.table.on("cpu", torch.float32), 0.0, 1.0))
    assert torch.equal(cm.assemble().dia.data, LK.assemble_fold_lean_masked_plain(
        cm.table.on("cpu", torch.float32), 0.0, 1.0))
    xb = torch.ones((8,) + cp._cdims)
    assert torch.equal(A.dia.matvec_blocked(xb),
                       LK.blocked_matvec_plain(A.dia.data, A.dia.trips, A.dia.classes, xb))
    assert counts() == before
    with pytest.raises(RuntimeError):
        LK.assemble_fold_lean_blocked(cp.table.on("meta", torch.float32), 0.0, 1.0)
    with pytest.raises(RuntimeError):
        LK.assemble_fold_lean_masked(cm.table.on("meta", torch.float32), 0.0, 1.0)
    with pytest.raises(RuntimeError):
        LK.blocked_matvec(A.dia.data.to("meta"), A.dia.trips, A.dia.classes, xb.to("meta"))
