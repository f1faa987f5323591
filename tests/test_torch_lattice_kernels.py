"""The modules holding K1 (fused lean-fold assembler) and K2 (DIA SpMV):
their plain PyTorch versions against the JAX package's Pallas kernels in
interpret mode (float32, rel 5e-6 as in tests/test_pallas_lattice.py) and
against its XLA paths (float64), on the same inputs."""

import dataclasses

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem.forms import grad as jgrad, inner as jinner
from dolfinx_mpc_tpu.fem.mesh import create_box as jx_box
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu.ops.pallas_lattice import make_dia_matvec_pallas, make_lean_fold_pallas
from dolfinx_mpc_tpu_torch.fem.forms import grad as pgrad, inner as pinner
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
