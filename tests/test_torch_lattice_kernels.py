"""The modules holding K1 (fused lean-fold assembler), K2 and K7 (DIA
SpMV) and K6 (blocked SpMV): their plain PyTorch versions against the JAX
package's Pallas kernels in interpret mode (float32, rel 5e-6 as in
tests/test_pallas_lattice.py) and against its XLA paths (float64), on the
same inputs; and the launches the operators and fold tables prepare for
the card (halo, parameter blocks, K6's packed triple table, the
assemblers' classes, K5's at window strides 1 and 2), which need no
card."""

import dataclasses
import functools
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
from torch_fold_tables import padded_table

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
    """Forms the assemblers do not cover take the element-kernel paths
    without any assembler launch (an x-dependent integrand on fold, the
    "cells" side format, a vector space at degree 2 on the refined
    65-offset grid, and a complex dtype, which raised NotImplementedError
    before complex scalars were ported: it takes the lean path, as the JAX
    package takes its XLA path, and equals the real operator); a
    non-separable Dirichlet set goes to K3's plain version on the CPU and
    equals the grid masking, and a degree-2 form assembles (K4)."""
    mesh = pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (3, 3, 3))
    V = pt.functionspace(mesh, ("Lagrange", 1))
    mpc = pt.MultiPointConstraint(V, np.float64, device="cpu")
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc.finalize()
    launches = lambda: tuple(getattr(LK, f).launches for f in (  # noqa: E731
        "assemble_fold_lean_factored", "assemble_fold_lean_masked", "assemble_fold_lean_blocked",
        "assemble_fold_lean_raw"))
    n0 = launches()
    a_x = pt.BilinearForm(V, lambda u, v, c: (1.0 + c.x[0]) * pinner(pgrad(u), pgrad(v)))
    assert LK._probe_constant_M(a_x.terms[0], 3) is None
    clf_x = pt_lattice(a_x, mpc, side_format="fold", device="cpu")
    assert clf_x._route == "lean" and clf_x.assemble().fold_axis == 0
    a = pt.BilinearForm(V, lambda u, v, c: pinner(pgrad(u), pgrad(v)))
    A_cells = pt_lattice(a, mpc, side_format="cells", device="cpu").assemble()
    assert A_cells.side_Aep.shape[0] > 0
    V3 = pt.functionspace(pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (2, 2, 2)), ("Lagrange", 2, (3,)))
    mpc3 = pt.MultiPointConstraint(V3, np.float64, device="cpu")
    mpc3.create_periodic_constraint_geometrical(
        V3, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc3.finalize()
    A3 = pt_lattice(pt.BilinearForm(V3, lambda u, v, c: pinner(pgrad(u), pgrad(v))), mpc3, side_format="fold",
                    device="cpu").assemble()
    assert len(A3.dia.offsets) == 65 and A3.dia.bs == 3
    assert launches() == n0
    mpc_c = pt.MultiPointConstraint(V, np.complex128, device="cpu")
    mpc_c.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc_c.finalize()
    clf_c = pt_lattice(a, mpc_c, dtype=np.complex128, side_format="fold", device="cpu")
    A_c = clf_c.assemble()
    assert clf_c._route == "lean" and launches() == n0 and A_c.dia.data.dtype == torch.complex128
    A_r = pt_lattice(a, mpc, side_format="fold", device="cpu").assemble()
    assert float((A_c.dia.data - A_r.dia.data).abs().max()) <= 1e-12 * float(A_r.dia.data.abs().max())
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
    degree = 2 if "P2" in case else 1
    if case == "P1 GMG":
        ops, _ = pt.build_gmg_hierarchy(lambda m: _pt_form_clf((m, m, m), 1, True), 8, 3, min_n=2)
        dias = [o.dia for o in ops] + [o.dia.abs() for o in ops]
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
    ops, _ = pt.build_gmg_hierarchy(lambda m: _pt_elasticity_clf((m, m, m)), 8, 3, min_n=2)
    dias = [o.dia for o in ops] + [o.dia.abs() for o in ops]
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


@pytest.mark.parametrize("itemsize", [8, 16], ids=["c64", "c128"])
def test_complex_spmv_launch_limits(itemsize):
    """K2, K7 and K6 at the complex element sizes (complex64 8 B,
    complex128 16 B): every ring of the paths' grids fits one block's
    shared memory (K2 and K7 at W = 1 on 65^3 and 129^3, K7 at the refined
    grid's 65 offsets, W = 2, on 65^3 x 3: 149,760 B at 16 B), K7 streams
    its planes at 65^3 (the bytes double), K2 never does; K6's ring of 8
    classes takes 512 plane points in complex64 and 256 in complex128
    (512 would need 330 KB), with the x planes per block of one resident
    wave; rows beyond shared memory still raise."""
    p1 = _pt_form_clf((2, 2, 2), 1, True).offsets
    p2 = _pt_form_clf((2, 2, 2), 2, True).offsets
    smem = lambda p: (2 * p.w + 2) * (256 + 2 * (p.w * p.n2 + p.w)) * p.bs * itemsize  # noqa: E731
    for offs, bs, n, w, stream in ((p1, 1, 65, 1, 0), (p1, 1, 129, 1, 0), (p1, 3, 65, 1, 1), (p1, 3, 129, 1, 1),
                                   (p2, 3, 65, 2, 1), (p2, 1, 129, 2, 0)):
        prm = LK.dia_launch_params(offs, (n, n, n), itemsize, bs)
        assert (prm.w, prm.bs, prm.stream) == (w, bs, stream) and smem(prm) <= 232448
    if itemsize == 16:
        assert smem(LK.dia_launch_params(p2, (65, 65, 65), 16, 3)) == 149760
    with pytest.raises(ValueError, match="shared memory"):
        LK.dia_launch_params(p1, (65, 65, 20000), itemsize, 1)
    trips = _pt_form_clf((2, 2, 2), 2, True).trips
    classes = tuple(itertools.product((0, 1), repeat=3))
    prm = LK.blocked_launch_params(trips, classes, (65, 65, 65), itemsize)
    assert (prm.pts, prm.li, prm.stream) == ((512, 5, 1) if itemsize == 8 else (256, 9, 1))
    assert 8 * (len(trips) + 1) + 4 * 8 * (prm.pts + 2 * 66) * itemsize <= 232448
    assert LK.blocked_launch_params(trips, classes, (33, 33, 33), itemsize).pts == (512 if itemsize == 8 else 256)
    with pytest.raises(ValueError, match="shared memory"):
        LK.blocked_launch_params(trips, classes, (5, 5, 4000), itemsize)


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


def _class_ids(edges, n, r=1):
    """The class of every point 0 .. n-1 of an axis with these classes
    (their first points, fold_edges), by the kernels' rule: the last class
    whose first point is <= x and shares x's parity mod r; at r = 1 the
    segment between two edges."""
    e, x = np.asarray(edges), np.arange(n)
    ok = (e[None, :] <= x[:, None]) & ((x[:, None] - e[None, :]) % r == 0)
    return len(e) - 1 - np.argmax(ok[:, ::-1], axis=1)


def _blob_clf(dims, degree):
    """A non-separable Dirichlet set (the y-planes and a ball on the y=0
    face): the port's K3 table on the CPU."""
    V = pt.functionspace(pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims), ("Lagrange", degree))
    bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)
        | ((x[0] - 0.5) ** 2 + x[1] ** 2 + (x[2] - 0.5) ** 2 < 0.35 ** 2)), V)
    mpc = _new_mpc(pt, V, np.float64)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: pinner(pgrad(u), pgrad(v)), quad_degree=degree)
    clf = pt_lattice(a, mpc, bcs=[bc], dtype=np.float64, side_format="fold", device="cpu")
    assert clf.table.factors is None and clf.table.keep is not None
    return clf


FOLD_CASES = ["P1", "bs=3", "P2 blocked", "P1 padded", "P2 blocked padded", "P2 blocked masked padded"]
# K5's raw tables at odd, unequal extents, and padded: the bs=3 vertex grid
# and the blocked P2 class grids at stride 1, the refined P2 grid at stride 2
K5_CASES = ["bs=3 raw", "P2 blocked raw", "P2 refined", "bs=3 raw padded", "P2 blocked raw padded",
            "P2 refined padded"]


@functools.lru_cache(maxsize=None)
def _fold_case_table(case):
    """The host table of one K1 / K4 / K3 case or one K5 case (K5_CASES:
    no masks)."""
    if case in K5_CASES:
        if case.startswith("bs=3"):
            table = LK.build_fold_table(_pt_elasticity_clf((3, 4, 5)))
        else:
            table = LK.build_fold_table(_pt_form_clf((2, 3, 4), 2, False), _refined=case.startswith("P2 refined"))
        assert table.factors is None and table.keep is None
    elif case.startswith("P1"):
        table = _pt_form_clf((3, 4, 5), 1, True).table
    elif case == "bs=3":
        table = _pt_elasticity_clf((2, 3, 3)).table
    elif "masked" in case:
        table = _blob_clf((2, 3, 4), 2).table
    else:
        table = _pt_form_clf((2, 3, 4), 2, True).table
    return padded_table(table, (1, 2, 0)) if case.endswith("padded") else table


def _in_windows(xs, corner, dims, r):
    """Whether the points xs (one array per axis) lie in the window of this
    corner and these box counts at stride r."""
    u = [x - corner[a] for a, x in enumerate(xs)]
    return np.logical_and.reduce([(v >= 0) & (v < r * dims[a]) & (v % r == 0) for a, v in enumerate(u)])


@pytest.mark.parametrize("case", FOLD_CASES + K5_CASES)
def test_fold_classes_hold_the_same_entries(case):
    """At every point of every plane, the entries whose window holds the
    point are the entries whose window holds its class's first point (the
    point at which the kernels compute the class value), the class taken
    by the kernels' rule; each first point lies in its own class.  At
    stride 1 each axis splits at the edges fold_edges gives, 3 segments on
    the unpadded grids and 4 where the grid runs beyond n + 1; at stride 2
    (K5 on the refined grid of 2n + 1 points) the classes are (segment,
    parity), (0, 1, 2, 3, 2n) per axis, and padded slots add their own."""
    table = _fold_case_table(case)
    r = table.refine
    assert r == (2 if "refined" in case else 1)
    edges = LK.fold_edges(table.vshape, table.dims, table.ent, r)
    assert edges == table.on("cpu", torch.float64).edges
    padded = case.endswith("padded")
    if r == 1:
        assert [len(e) for e in edges] == ([4, 4, 3] if padded else [3, 3, 3])
        assert all(e[:2] == (0, 1) for e in edges)
    else:
        assert [len(e) for e in edges] == ([6, 7, 5] if padded else [5, 5, 5])
        assert all(e[:4] == (0, 1, 2, 3) for e in edges) and edges[2][-1] == 2 * table.dims[2]
        assert (table.planes[:, 7] - table.planes[:, 6]).max() == 27
    ids = [_class_ids(e, n, r) for e, n in zip(edges, table.vshape)]
    for e, i in zip(edges, ids):
        assert np.array_equal(i[list(e)], np.arange(len(e)))
    pts = np.meshgrid(*[np.arange(n) for n in table.vshape], indexing="ij")
    reps = [np.asarray(e)[i][x] for e, i, x in zip(edges, ids, pts)]
    for corner in table.ent:
        assert np.array_equal(_in_windows(pts, corner, table.dims, r), _in_windows(reps, corner, table.dims, r))


@pytest.mark.parametrize("case", FOLD_CASES + K5_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fold_class_values_equal_window_sums_bit_for_bit(case, dtype):
    """The kernels' arithmetic emulated per class: each plane's class values
    by the entry-ordered loop at the class's first point (strided windows
    at stride 2), then broadcast over the classes' points by the kernels'
    class rule, equal the plain version's window slice-adds (_window_sums)
    bit for bit."""
    tab = _fold_case_table(case).on("cpu", dtype)
    r = tab.refine
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    jitter = 0.013
    s = np_dt(1.0 + jitter)
    s2 = s * s
    s3 = s2 * s
    ref, rows = LK._window_sums(tab, jitter)
    coef, ent = tab.coef.numpy(), tab.ent.numpy()
    ids = [_class_ids(e, n, r) for e, n in zip(tab.edges, tab.vshape)]
    got = np.empty(tuple(ref.shape), np_dt)
    for mi, (*_, e0, e1) in enumerate(rows):
        cls = np.empty([len(e) for e in tab.edges], np_dt)
        for c in np.ndindex(cls.shape):
            rep = [tab.edges[a][c[a]] for a in range(3)]
            acc = np_dt(0.0)
            for e in range(e0, e1):
                if _in_windows(rep, ent[e], tab.dims, r):
                    c0, c1, c2 = coef[e]
                    acc = np_dt(acc + np_dt(c0 * s3 + c1 * s2 + c2 * s))
            cls[c] = acc
        got[mi] = cls[np.ix_(*ids)]
    assert torch.equal(torch.as_tensor(got), ref) and ref.abs().max() > 0
    if case in K5_CASES:
        assert torch.equal(LK.assemble_fold_lean_raw_plain(tab, jitter), ref)


@pytest.mark.parametrize("case", FOLD_CASES)
def test_fold_launch_params_match_the_table(case):
    """The parameter block K1 / K4 / K3 launch with holds the table's planes,
    grid, window extents and class edges, and a thread layout that covers
    every column of every row once; a CPU table prepares no launch, its
    wrappers run the plain versions and count nothing, and preparing one
    for it raises."""
    table = _fold_case_table(case)
    masked = "masked" in case
    tab = table.on("cpu", torch.float32)
    n0, n1, n2 = table.vshape
    p = LK.fold_launch_params(table.vshape, table.dims, tab.edges, table.n_planes, tab.n_stack, 4,
                              "masked" if masked else "factored")
    assert (p.n_pl, p.n0, p.n1, p.n2, p.nx, p.ny, p.nz) == (table.n_planes, n0, n1, n2) + tuple(table.dims)
    assert [tuple(p.edge[a][:p.ne[a]]) for a in range(3)] == list(tab.edges)
    assert p.kw == n2 and p.g == min(3, n1) and p.threads == -(-p.g * n2 // 32) * 32
    assert (p.stream, p.stage) == (0, int(masked))  # a small output: plain stores
    cover = np.zeros((n1, n2), int)
    for u in range(p.g * p.kw):  # thread u: rows u // kw + g t, columns u % kw + kw t
        cover[u // p.kw::p.g, u % p.kw::p.kw] += 1
    assert (cover == 1).all()
    counts = [f.launches for f in (LK.assemble_fold_lean_factored, LK.assemble_fold_lean_blocked,
                                   LK.assemble_fold_lean_masked)]
    if masked:
        out = LK.assemble_fold_lean_masked(tab, 0.01, 1.0)
        assert torch.equal(out, LK.assemble_fold_lean_masked_plain(tab, 0.01, 1.0))
    else:
        k = LK.assemble_fold_lean_blocked if table.blocked else LK.assemble_fold_lean_factored
        assert torch.equal(k(tab, 0.01, 1.0), LK.assemble_fold_lean_factored_plain(tab, 0.01, 1.0))
    assert tab._launches == {}
    assert counts == [f.launches for f in (LK.assemble_fold_lean_factored, LK.assemble_fold_lean_blocked,
                                           LK.assemble_fold_lean_masked)]
    with pytest.raises(RuntimeError):
        LK.FoldLaunch(tab, "masked" if masked else "factored")


@pytest.mark.parametrize("planes,n,threads,stream", [(15, 65, 224, 0), (15, 129, 416, 1), (135, 65, 224, 1),
                                                     (230, 65, 224, 1)])
def test_fold_launch_params_on_the_path_shapes(planes, n, threads, stream):
    """The block K1 (P1 at 65^3 and 129^3, bs=3 at 65^3), K4 and K3 (P2, 230
    triples on the 65^3 class grids) take at n=64: edges (0, 1, n - 1) on
    each axis, three row groups in whole warps, evict-first stores where
    the output exceeds the 50 MB L2, and K3's keep planes staged in shared
    memory; more than 4 edges, more than 8 entries on a plane, 65,536
    planes and rows beyond shared memory raise."""
    edges = ((0, 1, n - 1),) * 3
    for masks in ("factored", "masked"):
        p = LK.fold_launch_params((n, n, n), (n - 1,) * 3, edges, planes, 8, 4, masks)
        assert type(p) is LK.FoldParams
        assert (p.g, p.kw, p.threads, p.stream, p.stage) == (3, n, threads, stream, int(masks == "masked"))
    # K3's keep planes leave shared memory only where they do not fit in it: beyond 337 x 337 points
    assert LK.fold_launch_params((n, 337, 337), (n - 1,) * 3, edges, planes, 8, 4, "masked").stage == 1
    assert LK.fold_launch_params((n, 338, 338), (n - 1,) * 3, edges, planes, 8, 4, "masked").stage == 0
    with pytest.raises(ValueError, match="edges"):
        LK.fold_launch_params((n, n, n), (n - 1,) * 3, ((0, 1, 2, 3, 4),) + edges[1:], planes, 8, 4)
    with pytest.raises(ValueError, match="entries"):
        LK.fold_launch_params((n, n, n), (n - 1,) * 3, edges, planes, 8, 4, n_entries=9)
    with pytest.raises(ValueError, match="planes"):
        LK.fold_launch_params((n, n, n), (n - 1,) * 3, edges, 65536, 8, 4)
    with pytest.raises(ValueError, match="shared memory"):
        LK.fold_launch_params((n, 20000, n), (n - 1,) * 3, edges, planes, 8, 8)


@pytest.mark.parametrize("case", K5_CASES)
def test_k5_launch_params_match_the_table(case):
    """K5's parameter block holds the table's planes, grid, window extents,
    stride and classes, stores plainly (a small output) and stages nothing,
    and its threads cover every column of every row once; a CPU table
    prepares no launch, K5's wrapper runs the plain version there and
    counts nothing, and preparing a launch for it raises."""
    table = _fold_case_table(case)
    tab = table.on("cpu", torch.float32)
    n0, n1, n2 = table.vshape
    p = LK.fold_launch_params(table.vshape, table.dims, tab.edges, table.n_planes, 0, 4, "raw", tab.n_entries,
                              table.refine)
    assert (p.n_pl, p.n0, p.n1, p.n2, p.nx, p.ny, p.nz) == (table.n_planes, n0, n1, n2) + tuple(table.dims)
    assert [tuple(p.edge[a][:p.ne[a]]) for a in range(3)] == list(tab.edges)
    assert type(p) is (LK.FoldParamsR2 if table.refine == 2 else LK.FoldParams) and (p.stream, p.stage) == (0, 0)
    assert p.kw == n2 and p.g == min(4, n1) and p.threads == -(-p.g * n2 // 32) * 32
    cover = np.zeros((n1, n2), int)
    for u in range(p.g * p.kw):  # thread u: rows u // kw + g t, columns u % kw + kw t
        cover[u // p.kw::p.g, u % p.kw::p.kw] += 1
    assert (cover == 1).all()
    n5 = LK.assemble_fold_lean_raw.launches
    assert torch.equal(LK.assemble_fold_lean_raw(tab, 0.01), LK.assemble_fold_lean_raw_plain(tab, 0.01))
    assert tab._launches == {} and LK.assemble_fold_lean_raw.launches == n5
    with pytest.raises(RuntimeError):
        LK.FoldLaunch(tab, "raw")
    with pytest.raises(RuntimeError):
        LK.assemble_fold_lean_raw(table.on("meta", torch.float32), 0.0)


@pytest.mark.parametrize("planes,n,r,g,threads", [(230, 65, 1, 4, 288), (135, 65, 1, 4, 288), (65, 129, 2, 3, 416)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_k5_launch_params_on_the_path_shapes(planes, n, r, g, threads, itemsize):
    """The block K5 takes on its three tables at n=64 (the blocked P2
    triples and the bs=3 planes on 65^3, the refined P2 planes on 129^3 at
    stride 2): classes (0, 1, 64) per axis at stride 1 and (0, 1, 2, 3, 128)
    at stride 2 (corners 0 .. r, windows of 64 boxes), four row groups of
    65 columns and three of 129 in whole warps, evict-first stores (every
    output exceeds the 50 MB L2),
    nothing staged, and a block's shared memory well inside the 48 KB that
    needs no opt-in."""
    ent = [(d, d, d) for d in range(r + 1)]
    edges = LK.fold_edges((n, n, n), (64, 64, 64), ent, r)
    assert edges == (((0, 1, 64),) * 3 if r == 1 else ((0, 1, 2, 3, 128),) * 3)
    p = LK.fold_launch_params((n, n, n), (64, 64, 64), edges, planes, 0, itemsize, "raw", (r + 1) ** 3, r)
    assert type(p) is (LK.FoldParamsR2 if r == 2 else LK.FoldParams)
    assert (p.g, p.kw, p.threads, p.stream, p.stage) == (g, n, threads, 1, 0)
    assert [p.ne[a] for a in range(3)] == [len(e) for e in edges]
    assert LK.fold_smem_bytes(n, n, itemsize, "raw", False, r) < 48 * 1024


def test_k5_limits_raise():
    """K5's limits: more entries on a plane than its stride's bound (8 at
    stride 1, 27 at stride 2), more classes on an axis than the parameter
    block holds at that stride (4, 8), a stride other than 1 or 2, or a
    stride of 2 for the masked assemblers all raise."""
    vshape, dims = (129, 129, 129), (64, 64, 64)
    e1, e2 = ((0, 1, 64),) * 3, ((0, 1, 2, 3, 128),) * 3
    assert type(LK.fold_launch_params(vshape, dims, e2, 65, 0, 4, "raw", 27, 2)) is LK.FoldParamsR2
    with pytest.raises(ValueError, match="entries"):
        LK.fold_launch_params(vshape, dims, e2, 65, 0, 4, "raw", 28, 2)
    with pytest.raises(ValueError, match="entries"):
        LK.fold_launch_params(vshape, dims, e1, 65, 0, 4, "raw", 9, 1)
    with pytest.raises(ValueError, match="edges"):
        LK.fold_launch_params(vshape, dims, (tuple(range(9)),) + e2[1:], 65, 0, 4, "raw", 27, 2)
    with pytest.raises(ValueError, match="edges"):
        LK.fold_launch_params(vshape, dims, ((0, 1, 2, 3, 128),) + e1[1:], 65, 0, 4, "raw", 8, 1)
    with pytest.raises(ValueError, match="stride"):
        LK.fold_launch_params(vshape, dims, e2, 65, 0, 4, "raw", 27, 3)
    for masks in ("factored", "masked"):
        with pytest.raises(ValueError, match="stride"):
            LK.fold_launch_params(vshape, dims, e2, 65, 0, 4, masks, 27, 2)
