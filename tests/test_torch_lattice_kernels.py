"""The modules holding K1 (fused lean-fold assembler), K2 and K7 (DIA
SpMV) and K6 (blocked SpMV): their plain PyTorch versions against the JAX
package's Pallas kernels in interpret mode (float32, rel 5e-6 as in
tests/test_pallas_lattice.py) and against its XLA paths (float64), on the
same inputs; and the launches the operators prepare for the card (halo,
parameter blocks, K6's packed triple table), which need no card."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem.forms import grad as jgrad, inner as jinner
from dolfinx_mpc_tpu.fem.mesh import create_box as jx_box
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu.ops.pallas_lattice import make_dia_matvec_pallas, make_lean_fold_pallas
from dolfinx_mpc_tpu_torch.fem.forms import conj as pconj, div as pdiv, grad as pgrad, inner as pinner, sym as psym
from dolfinx_mpc_tpu_torch.fem.mesh import create_box as pt_box
from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
from dolfinx_mpc_tpu_torch.ops.lattice import assemble_matrix_lattice as pt_lattice
from dolfinx_mpc_tpu_torch.utils.interop import dia_from_numpy, fold_operator_from_numpy

DIMS = [(4, 4, 4), (3, 4, 5)]


def _new_mpc(pkg, V, dtype):
    """pkg.MultiPointConstraint(V, dtype), on the CPU for the port (its
    entry points default to the card)."""
    return pkg.MultiPointConstraint(V, dtype, **({"device": "cpu"} if pkg is pt else {}))


def _clf(pkg, box, lattice, gradf, innerf, dims, dtype, **kw):
    mesh = box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims)
    V = pkg.functionspace(mesh, ("Lagrange", 1))
    bdofs = pkg.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0))
    bc = pkg.dirichletbc(0.0, bdofs, V)
    mpc = _new_mpc(pkg, V, dtype)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0),
        lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pkg.BilinearForm(V, lambda u, v, c: innerf(gradf(u), gradf(v)), quad_degree=1)
    return lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold", **kw)


def _jx_clf(dims, dtype):
    return _clf(jx, jx_box, jx_lattice, jgrad, jinner, dims, dtype)


def _pt_clf(dims, dtype):
    return _clf(pt, pt_box, pt_lattice, pgrad, pinner, dims, dtype, device="cpu")


def _rel_max(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("jitter", [0.0, 0.037])
def test_k1_plain_matches_pallas_interpret_f32(dims, jitter):
    import jax.numpy as jnp

    cj = _jx_clf(dims, np.float32)
    cp = _pt_clf(dims, np.float32)
    assert cp.offsets == cj.offsets
    dv = 1.7
    pal = make_lean_fold_pallas(cj, interpret=True, fuse_mask=True)
    ref = np.asarray(pal(jnp.float32(jitter), cj._keep_grid, jnp.float32(dv), cj._bc_ind_grid))
    got = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float32), jitter, dv)
    assert got.dtype == torch.float32
    assert _rel_max(got.numpy(), ref) < 5e-6


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("jitter", [0.0, 0.013, -0.2])
def test_k1_plain_matches_xla_lean_f64(dims, jitter):
    import jax.numpy as jnp

    cj = _jx_clf(dims, np.float64)
    cp = _pt_clf(dims, np.float64)
    ref = np.asarray(cj._assemble_fold_lean(jnp.float64(jitter), jnp.float64(1.0),
                                            cj._keep_grid).dia.data)
    got = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float64), jitter, 1.0)
    assert _rel_max(got.numpy().reshape(ref.shape), ref) < 1e-12


def test_k1_factored_masks_equal_grid_masking():
    """K1's fused masks == unmasked planes + _zero_bc_on_grid + _diag_adds
    (the JAX package's separate masking passes, ported)."""
    cp = _pt_clf((3, 4, 5), np.float64)
    n0, n1, n2 = cp.vshape
    raw_tab = dataclasses.replace(
        cp.table, factors=tuple(np.ones_like(f) for f in cp.table.factors), _on={})
    raw = LK.assemble_fold_lean_factored_plain(raw_tab.on("cpu", torch.float64), 0.02, 2.3)
    raw = raw.reshape(len(cp.offsets), 1, 1, n0, n1, n2)
    ref = cp._diag_adds(cp._zero_bc_on_grid(raw, torch.as_tensor(cp._keep_grid)), 2.3)
    fused = LK.assemble_fold_lean_factored_plain(cp.table.on("cpu", torch.float64), 0.02, 2.3)
    assert torch.equal(fused.reshape(ref.shape), ref)


@pytest.mark.parametrize("dims", DIMS)
def test_k2_plain_matches_pallas_interpret_f32(dims):
    import jax.numpy as jnp

    dia = _jx_clf(dims, np.float32).assemble().dia
    x = np.random.default_rng(0).standard_normal(dia.shape[0]).astype(np.float32)
    ref = np.asarray(make_dia_matvec_pallas(dia.offsets, dia.vshape, interpret=True)(
        dia.data, jnp.asarray(x)))
    dp = dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.vshape, 1, device="cpu")
    got = dp.matvec(torch.as_tensor(x))
    assert got.dtype == torch.float32
    assert _rel_l2(got.numpy(), ref) < 5e-6


@pytest.mark.parametrize("dims", DIMS)
def test_k2_plain_matches_xla_f64(dims):
    import jax.numpy as jnp

    dia = _jx_clf(dims, np.float64).assemble().dia
    x = np.random.default_rng(1).standard_normal(dia.shape[0])
    ref = np.asarray(dia.matvec(jnp.asarray(x)))
    got = dia_from_numpy(np.asarray(dia.data), dia.offsets, dia.vshape, 1, device="cpu").matvec(torch.as_tensor(x))
    assert _rel_l2(got.numpy(), ref) < 1e-13


@pytest.mark.parametrize("dims", DIMS)
def test_fold_operator_matches_jax(dims):
    """Fold LatticeOperator matvec / diagonal / to_scipy equal the JAX
    package's, both on the JAX operator's own data (interop) and on the
    port's assembled operator."""
    import jax.numpy as jnp

    Aj = _jx_clf(dims, np.float64).assemble()
    Ap = _pt_clf(dims, np.float64).assemble()
    Ai = fold_operator_from_numpy(
        dia_from_numpy(np.asarray(Aj.dia.data), Aj.dia.offsets, Aj.dia.vshape, 1, device="cpu"),
        Aj.fold_axis, np.asarray(Aj.fold_mask), Aj.diagval, fold_pairs=Aj.fold_pairs, device="cpu")
    x = np.random.default_rng(2).standard_normal(Aj.shape[0])
    y_ref = np.asarray(Aj.matvec(jnp.asarray(x)))
    d_ref = np.asarray(Aj.diagonal())
    S_ref = Aj.to_scipy()
    for A in (Ai, Ap):
        assert _rel_l2(A.matvec(torch.as_tensor(x)).numpy(), y_ref) < 1e-13
        assert _rel_max(A.diagonal().numpy(), d_ref) < 1e-13
        assert abs(A.to_scipy() - S_ref).max() < 1e-13 * abs(S_ref).max()


def test_wrappers_run_plain_on_cpu_and_refuse_other_devices():
    """CPU tensors take the plain versions and launch nothing; a tensor on
    any other non-CUDA device raises instead of falling back."""
    cp = _pt_clf((3, 3, 3), np.float32)
    tab = cp.table.on("cpu", torch.float32)
    n_k1, n_k2 = LK.assemble_fold_lean_factored.launches, LK.dia_matvec.launches
    a = LK.assemble_fold_lean_factored(tab, 0.01, 1.0)
    assert torch.equal(a, LK.assemble_fold_lean_factored_plain(tab, 0.01, 1.0))
    A = cp.assemble()
    x = torch.ones(A.shape[0])
    y = A.dia.matvec(x)
    assert torch.equal(y, LK.dia_matvec_plain(A.dia.data, A.dia.offsets, A.dia.vshape, 1, x))
    assert (LK.assemble_fold_lean_factored.launches, LK.dia_matvec.launches) == (n_k1, n_k2)
    with pytest.raises(RuntimeError):
        LK.dia_matvec(A.dia.data.to("meta"), A.dia.offsets, A.dia.vshape, x.to("meta"))
    with pytest.raises(RuntimeError):
        LK.assemble_fold_lean_factored(cp.table.on("meta", torch.float32), 0.0, 1.0)


def test_unported_lattice_forms_raise():
    """Forms the assemblers do not cover (x-dependent integrands, the
    "cells" side format, a vector space at degree 2) raise
    NotImplementedError naming their ROADMAP item instead of silently
    taking another path; a non-separable Dirichlet set goes to K3's plain
    version on the CPU and equals the grid masking, and a degree-2 form
    assembles (K4)."""
    mesh = pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (3, 3, 3))
    V = pt.functionspace(mesh, ("Lagrange", 1))
    mpc = pt.MultiPointConstraint(V, np.float64, device="cpu")
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc.finalize()
    a_x = pt.BilinearForm(V, lambda u, v, c: (1.0 + c.x[0]) * pinner(pgrad(u), pgrad(v)))
    assert LK._probe_constant_M(a_x.terms[0], 3) is None
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt_lattice(a_x, mpc, side_format="fold", device="cpu")
    a = pt.BilinearForm(V, lambda u, v, c: pinner(pgrad(u), pgrad(v)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pt_lattice(a, mpc, side_format="cells", device="cpu")
    V3 = pt.functionspace(pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (2, 2, 2)), ("Lagrange", 2, (3,)))
    mpc3 = pt.MultiPointConstraint(V3, np.float64, device="cpu")
    mpc3.create_periodic_constraint_geometrical(
        V3, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc3.finalize()
    with pytest.raises(NotImplementedError, match="item 14"):
        pt_lattice(pt.BilinearForm(V3, lambda u, v, c: pinner(pgrad(u), pgrad(v))), mpc3, side_format="fold", device="cpu")
    blob = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(V, lambda x: x.sum(axis=0) < 0.35), V)
    clf = pt_lattice(a, mpc, bcs=[blob], side_format="fold", device="cpu")
    assert clf.table.factors is None
    n_k1, n_k3 = LK.assemble_fold_lean_factored.launches, LK.assemble_fold_lean_masked.launches
    A = clf.assemble()
    assert (LK.assemble_fold_lean_factored.launches, LK.assemble_fold_lean_masked.launches) == (n_k1, n_k3)
    raw_tab = dataclasses.replace(clf.table, keep=np.ones_like(clf.table.keep),
                                  bc_ind=np.zeros_like(clf.table.bc_ind), _on={})
    raw = LK.assemble_fold_lean_masked_plain(raw_tab.on("cpu", torch.float64), 0.0, 1.0)
    raw = raw.reshape(A.dia.data.shape)
    ref = clf._diag_adds(clf._zero_bc_on_grid(raw, torch.as_tensor(clf._keep_grid)), 1.0)
    assert torch.equal(A.dia.data, ref)
    # degree 2 assembles on the parity-blocked layout
    V2 = pt.functionspace(mesh, ("Lagrange", 2))
    mpc2 = pt.MultiPointConstraint(V2, np.float64, device="cpu")
    mpc2.create_periodic_constraint_geometrical(
        V2, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc2.finalize()
    a2 = pt.BilinearForm(V2, lambda u, v, c: pinner(pgrad(u), pgrad(v)))
    A2 = pt_lattice(a2, mpc2, side_format="fold", device="cpu").assemble()
    assert A2.supports_blocked() and A2.dia.data.shape == (230, 4, 4, 4)


def _pt_form_clf(dims, degree, with_bc):
    """The port's P1 / P2 Poisson fold form on the CPU, with the y-plane
    Dirichlet set or (Dirichlet-free) the reaction-diffusion form."""
    V = pt.functionspace(pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims), ("Lagrange", degree))
    bcs = [pt.dirichletbc(0.0, pt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)] if with_bc else []
    mpc = _new_mpc(pt, V, np.float64)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), bcs)
    mpc.finalize()
    if with_bc:
        a = pt.BilinearForm(V, lambda u, v, c: pinner(pgrad(u), pgrad(v)), quad_degree=degree)
    else:
        a = pt.BilinearForm(V, lambda u, v, c: pinner(pgrad(u), pgrad(v)) + 0.5 * pinner(u, v),
                            quad_degree=degree + 1)
    return pt_lattice(a, mpc, bcs=bcs, dtype=np.float64, side_format="fold", device="cpu")


@pytest.mark.parametrize("case", ["P1 GMG", "P2 refined", "Dirichlet-free P1", "Dirichlet-free P2 refined"])
def test_k2_halo_covers_every_dia_of_the_paths(case):
    """Every scalar DIA operator the paths build has its offsets within K2's
    halo width (W = 2): the P1 fine level and its GMG levels (with the
    absolute-value copies the Chebyshev bounds take), the refined degree-2
    DIA (65 offsets, |d| <= 2) and the Dirichlet-free forms (K5's tables);
    K2's parameter block builds for each, and an offset of 3 raises."""
    from dolfinx_mpc_tpu_torch.la.gmg import _abs_dia

    degree = 2 if "P2" in case else 1
    if case == "P1 GMG":
        ops, _ = pt.build_gmg_hierarchy(lambda m: _pt_form_clf((m, m, m), 1, True), 8, 3, min_n=2)
        dias = [o.dia for o in ops] + [_abs_dia(o.dia) for o in ops]
        assert [d.vshape for d in dias[:3]] == [(9, 9, 9), (5, 5, 5), (3, 3, 3)]
        offsets = [(d.offsets, d.vshape) for d in dias]
    else:
        clf = _pt_form_clf((2, 3, 4), degree, case.startswith("P2"))
        offsets = [(clf.offsets, clf.vshape)]
        if degree == 1:
            A = clf.assemble()
            offsets.append((A.dia.offsets, A.dia.vshape))
    for offs, vshape in offsets:
        assert LK.k2_halo_width(offs) <= LK.K2_MAX_HALO
        assert LK.dia_launch_params(offs, vshape).n == len(offs)
        if degree == 2:
            assert len(offs) == 65 and LK.k2_halo_width(offs) == 2
    with pytest.raises(ValueError, match="halo"):
        LK.dia_launch_params(list(offsets[0][0]) + [(0, 0, 3)], offsets[0][1])


@pytest.mark.parametrize("degree,dims", [(1, (3, 4, 5)), (2, (2, 3, 4))])
def test_k2_prepared_launch_equals_its_dia(degree, dims):
    """The parameter block K2 is launched with holds its DIA's offsets (as
    plane offset, flat shift dj*n2 + dk and dk, in offset order), its grid,
    a halo width >= every |d|, and x-plane chunks that cover the grid."""
    clf = _pt_form_clf(dims, degree, degree == 1)
    offs, (n0, n1, n2) = clf.offsets, clf.vshape
    p = LK.dia_launch_params(offs, clf.vshape)
    assert (p.n, p.n0, p.n1, p.n2) == (len(offs), n0, n1, n2)
    assert [(p.di[d], p.sh[d], p.dk[d]) for d in range(p.n)] == [(di, dj * n2 + dk, dk) for di, dj, dk in offs]
    assert p.w == max(1, max(abs(v) for o in offs for v in o)) and p.li == 1  # a small grid: one plane each
    big = LK.dia_launch_params(offs, (129, 129, 129))
    assert big.li == 4 and -(-129 * 129 // 256) * -(-129 // big.li) >= 16 * 132


def _pt_elasticity_clf(dims):
    """The port's bs=3 elasticity fold form (bench.py's BENCH_BS=3: mu 1,
    lambda 1.25, periodic in x, Dirichlet on the y-planes) on the CPU."""
    V = pt.functionspace(pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims), ("Lagrange", 1, (3,)))
    bc = pt.dirichletbc(np.zeros(3), pt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = _new_mpc(pt, V, np.float64)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: 2.0 * pinner(psym(pgrad(u)), psym(pgrad(v)))
                        + 1.25 * pdiv(u) * pconj(pdiv(v)), quad_degree=1)
    return pt_lattice(a, mpc, bcs=[bc], dtype=np.float64, side_format="fold", device="cpu")


def test_k7_halo_covers_every_dia_of_the_elasticity_gmg():
    """Every bs=3 DIA the elasticity GMG builds, and the absolute-value
    copies its Chebyshev bounds take, fits K7's halo and parameter block in
    f32 and f64: the block holds the DIA's offsets in order (plane offset,
    flat shift dj*n2 + dk, dk), bs 3, the halo width and one x plane per
    block; an offset of 3 raises."""
    from dolfinx_mpc_tpu_torch.la.gmg import _abs_dia

    ops, _ = pt.build_gmg_hierarchy(lambda m: _pt_elasticity_clf((m, m, m)), 8, 3, min_n=2)
    dias = [o.dia for o in ops] + [_abs_dia(o.dia) for o in ops]
    assert [d.vshape for d in dias[:3]] == [(9, 9, 9), (5, 5, 5), (3, 3, 3)]
    assert all(d.bs == 3 and d.data.shape[1:3] == (3, 3) for d in dias)
    for d in dias:
        n2 = d.vshape[2]
        for itemsize in (4, 8):
            p = LK.dia_launch_params(d.offsets, d.vshape, itemsize, 3)
            assert (p.n, p.bs, p.w, p.li) == (len(d.offsets), 3, LK.k2_halo_width(d.offsets), 1)
            assert p.w <= LK.K2_MAX_HALO
            assert [(p.di[i], p.sh[i], p.dk[i]) for i in range(p.n)] == [
                (di, dj * n2 + dk, dk) for di, dj, dk in d.offsets]
    with pytest.raises(ValueError, match="halo"):
        LK.dia_launch_params(list(dias[0].offsets) + [(3, 0, 0)], dias[0].vshape, 4, 3)


@pytest.mark.parametrize("n,li", [(65, 1), (33, 1), (17, 1), (129, 4)])
def test_k7_parameter_block_on_the_path_grids(n, li):
    """K7's block on the bs=3 path's grids (and 129^3): one x plane per
    block at 65^3 and below, K2's rule beyond, evict-first data loads where
    the planes exceed the 50 MB L2 (65^3 and up in f32); bs 2 and 3 take
    it, bs 4 and a grid whose rows overflow shared memory raise.  K2 never
    streams."""
    offs = _pt_form_clf((2, 2, 2), 1, True).offsets
    for bs in (2, 3):
        p = LK.dia_launch_params(offs, (n, n, n), 4, bs)
        assert (p.bs, p.n0, p.n1, p.n2, p.li, p.stream) == (bs, n, n, n, li, int(n >= 65))
    assert LK.dia_launch_params(offs, (n, n, n), 4, 1).stream == 0
    with pytest.raises(ValueError, match="bs=4"):
        LK.dia_launch_params(offs, (n, n, n), 4, 4)
    with pytest.raises(ValueError, match="shared memory"):
        LK.dia_launch_params(offs, (n, n, 20000), 8, 3)


def _decode_k6_table(tab, s2):
    """K6's packed rows back to (row class, m, column class, di, flat shift,
    dk, last of its class)."""
    x, y = tab[:, 0].astype(np.int64), tab[:, 1].astype(np.int64)
    return [(int(yy >> 16 & 31), int(yy & 0xffff), int(xx >> 24), int((yy >> 22 & 3) - 1),
             int((xx & 0xffffff) - (s2 + 1)), int((yy >> 24 & 3) - 1), int(yy >> 21 & 1)) for xx, yy in zip(x, y)]


@pytest.mark.parametrize("dims", [(2, 3, 4), (3, 3, 3)])
def test_k6_prepared_table_is_the_plain_sum_order(dims):
    """K6's device table lists each row class's triples in triple order (the
    order the plain version sums them), classes in order, each flagged last
    at its end, with column classes, di, dk and flat shifts dj*s2 + dk that
    match the triples; the parameter block covers the class grids."""
    dia = _pt_form_clf(dims, 2, True).assemble().dia
    trips, classes, cdims = dia.trips, dia.classes, dia.cdims
    assert len(trips) == 230 and len(classes) == 8
    s2 = cdims[2]
    rows = _decode_k6_table(LK.blocked_launch_table(trips, classes, cdims), s2)
    cid = {c: i for i, c in enumerate(classes)}
    want = []
    for ci, c in enumerate(classes):
        ms = [m for m, (cr, _, _) in enumerate(trips) if cr == c]
        for k, m in enumerate(ms):
            _, cc, (di, dj, dk) = trips[m]
            want.append((ci, m, cid[cc], di, dj * s2 + dk, dk, int(k == len(ms) - 1)))
    assert rows == want
    p = LK.blocked_launch_params(trips, classes, cdims)
    assert (p.n_cls, p.n_trip, p.s0, p.s1, p.s2, p.empty) == (8, 230) + tuple(cdims) + (0,)
    assert (p.pts, p.li, p.stream) == (512, 1, 0)
    # a row class without triples is flagged: the kernel writes 0 there
    part = [t for t in trips if t[0] != classes[7]]
    assert LK.blocked_launch_params(part, classes, cdims).empty == 1 << 7
    assert [r[0] for r in _decode_k6_table(LK.blocked_launch_table(part, classes, cdims), s2)] == [
        r[0] for r in rows if r[0] != 7]


def test_k6_launch_rule_and_limits():
    """K6 takes the fewest x planes per block that keep every block resident
    in one wave: 3 at 8 x 65^3 in f32 (9 tiles x 65 planes over 264 blocks),
    1 at 8 x 33^3, with evict-first data loads only where the planes exceed
    the L2; coarse offsets beyond ±1, more than 32 classes and rows
    beyond one block's shared memory raise."""
    trips = _pt_form_clf((2, 2, 2), 2, True).trips
    classes = tuple(itertools.product((0, 1), repeat=3))
    p65, p33 = (LK.blocked_launch_params(trips, classes, (n, n, n)) for n in (65, 33))
    assert (p65.li, p65.stream, p33.li, p33.stream) == (3, 1, 1, 0)  # 253 MB streams, 33 MB stays in L2
    assert LK.blocked_launch_params(trips, classes, (65, 65, 65), 8).li == 5  # one f64 block per SM
    with pytest.raises(ValueError, match="±1"):
        LK.blocked_launch_table(list(trips) + [(classes[0], classes[1], (2, 0, 0))], classes, (5, 5, 5))
    with pytest.raises(ValueError, match="classes"):
        LK.blocked_launch_params(trips, classes * 5, (5, 5, 5))
    with pytest.raises(ValueError, match="shared memory"):
        LK.blocked_launch_params(trips, classes, (5, 5, 4000), 8)


def test_prepared_launches_refuse_cpu_data_and_cpu_operators_launch_nothing():
    """The prepared launches are for CUDA data only (CPU data raises, as
    does K7 at bs 1); a DIAMatrix at bs=3 or a BlockDIAMatrix on the CPU
    prepares none, runs the plain version and counts no launch."""
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, DIAMatrix

    clf = _pt_elasticity_clf((2, 2, 2))
    d = clf.assemble().dia
    with pytest.raises(RuntimeError):
        LK.DiaBsMatvecLaunch(d.data, d.offsets, d.vshape, 3)
    with pytest.raises(ValueError, match="bs=1"):
        LK.DiaBsMatvecLaunch(d.data, d.offsets, d.vshape, 1)
    b = _pt_form_clf((2, 2, 2), 2, True).assemble().dia
    with pytest.raises(RuntimeError):
        LK.BlockedMatvecLaunch(b.data, b.trips, b.classes)
    n7, n6 = LK.dia_matvec_bs.launches, LK.blocked_matvec.launches
    d2 = DIAMatrix(d.data, d.offsets, d.vshape, 3)
    x = torch.ones(d2.shape[0], dtype=d.data.dtype)
    assert torch.equal(d2.matvec(x), LK.dia_matvec_plain(d.data, d.offsets, d.vshape, 3, x))
    b2 = BlockDIAMatrix(b.data, b.trips, b.vshape, b.r3)
    xb = torch.ones((8,) + b.cdims, dtype=b.data.dtype)
    assert torch.equal(b2.matvec_blocked(xb), LK.blocked_matvec_plain(b.data, b.trips, b.classes, xb))
    assert d2._launch is None and b2._launch is None
    assert (LK.dia_matvec_bs.launches, LK.blocked_matvec.launches) == (n7, n6)
