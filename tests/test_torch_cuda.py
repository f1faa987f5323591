"""K1 to K7 on the card against their plain PyTorch versions, and the f64
oracles through the card's kernels.  Marked `cuda`: skipped where there is
no CUDA card (the CPU suite); run on one with
``python -m pytest tests/test_torch_cuda.py -q``."""

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
from dolfinx_mpc_tpu_torch.fem.mesh import create_box
from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda")


def _y_planes(x):
    return np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)


def _blob(x):
    """Non-separable: the y-planes and a ball about (0.5, 0, 0.5), clear of
    the periodic planes (see tests/test_torch_blocked.py)."""
    return _y_planes(x) | ((x[0] - 0.5) ** 2 + x[1] ** 2 + (x[2] - 0.5) ** 2 < 0.35 ** 2)


def _problem(dims, dtype, device, degree=1, marker=_y_planes):
    mesh = create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims)
    V = pt.functionspace(mesh, ("Lagrange", degree))
    bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(V, marker), V)
    mpc = pt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=degree)
    L = pt.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0]) * v.value)
    clf = pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, device=device)
    return V, bc, mpc, a, L, clf


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_k1_and_k2_match_plain_on_card(cuda, dtype, tol):
    clf = _problem((7, 9, 11), np.float64, cuda)[5]
    tab = clf.table.on(cuda, dtype)
    n1 = LK.assemble_fold_lean_factored.launches
    got = LK.assemble_fold_lean_factored(tab, 0.02, 1.3)
    ref = LK.assemble_fold_lean_factored_plain(tab, 0.02, 1.3)
    torch.cuda.synchronize()
    assert LK.assemble_fold_lean_factored.launches == n1 + 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol
    dia = clf.assemble().dia
    data = dia.data.to(dtype).contiguous()
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x = torch.randn(dia.shape[0], generator=g, device=cuda, dtype=dtype)
    y = LK.dia_matvec(data, dia.offsets, dia.vshape, x)
    y_ref = LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 1, x)
    assert float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref)) <= max(tol, 1e-13)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_k3_k4_k6_match_plain_on_card(cuda, dtype, tol):
    clf = _problem((3, 4, 5), np.float64, cuda, degree=2)[5]
    tab = clf.table.on(cuda, dtype)
    n4 = LK.assemble_fold_lean_blocked.launches
    got = LK.assemble_fold_lean_blocked(tab, 0.02, 1.3)
    ref = LK.assemble_fold_lean_factored_plain(tab, 0.02, 1.3)
    torch.cuda.synchronize()
    assert LK.assemble_fold_lean_blocked.launches == n4 + 1
    assert float((got - ref).abs().max() / ref.abs().max()) <= tol
    dia = clf.assemble().dia
    data = dia.data.to(dtype).contiguous()
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    xb = torch.randn((8,) + dia.cdims, generator=g, device=cuda, dtype=dtype)
    n6 = LK.blocked_matvec.launches
    y = LK.blocked_matvec(data, dia.trips, dia.classes, xb)
    y_ref = LK.blocked_matvec_plain(data, dia.trips, dia.classes, xb)
    assert LK.blocked_matvec.launches == n6 + 1
    assert float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref)) <= max(tol, 1e-13)
    for degree, dims in ((1, (5, 6, 7)), (2, (3, 4, 5))):
        clf = _problem(dims, np.float64, cuda, degree=degree, marker=_blob)[5]
        tab = clf.table.on(cuda, dtype)
        n3 = LK.assemble_fold_lean_masked.launches
        got = LK.assemble_fold_lean_masked(tab, 0.02, 1.3)
        ref = LK.assemble_fold_lean_masked_plain(tab, 0.02, 1.3)
        torch.cuda.synchronize()
        assert LK.assemble_fold_lean_masked.launches == n3 + 1
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol


@pytest.mark.parametrize("degree,dims,marker", [(1, (5, 6, 7), _y_planes), (2, (3, 3, 3), _y_planes),
                                                 (1, (5, 6, 7), _blob)])
def test_linear_problem_f64_on_card_meets_oracle(cuda, degree, dims, marker):
    import scipy.sparse.linalg as spla

    from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix

    V, bc, mpc, a, L, _ = _problem(dims, np.float64, cuda, degree, marker)
    counter = LK.blocked_matvec if degree == 2 else LK.dia_matvec
    n2 = counter.launches
    prob = pt.LinearProblem(a, L, mpc, bcs=[bc],
                            petsc_options={"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12})
    u = prob.solve().x.array
    assert u.device.type == "cuda" and counter.launches > n2
    A = assemble_matrix_scipy(a, [bc])
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [[bc]],
                                   device="cpu"), [bc]).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)
    assert np.abs(u.cpu().numpy() - u_ref).max() < 1e-8


def _elasticity_problem(dims, dtype, device):
    """bench.py's bs=3 problem at `dims`: P1 vector tets, periodic in x,
    Dirichlet np.zeros(3) on the y-planes, a vector source."""
    mesh = create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims)
    V = pt.functionspace(mesh, ("Lagrange", 1, (3,)))
    bc = pt.dirichletbc(np.zeros(3), pt.locate_dofs_geometrical(V, _y_planes), V)
    mpc = pt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v)))
                        + 1.25 * div(u) * conj(div(v)), quad_degree=1)
    L = pt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0]
                      + 0.5 * c.x[1] * v.value[..., 1] - v.value[..., 2])
    clf = pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, device=device)
    return V, [bc], mpc, a, L, clf


def _free_problem(dims, dtype, device, degree):
    """The reaction-diffusion form without Dirichlet dofs, periodic in x."""
    mesh = create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims)
    V = pt.functionspace(mesh, ("Lagrange", degree))
    mpc = pt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)) + 0.5 * inner(u, v),
                        quad_degree=degree + 1)
    L = pt.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0] * c.x[2]) * v.value)
    clf = pt.assemble_matrix_lattice(a, mpc, bcs=[], dtype=dtype, device=device)
    return V, [], mpc, a, L, clf


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_k1_bs3_k5_k7_match_plain_on_card(cuda, dtype, tol):
    clf = _elasticity_problem((5, 6, 7), np.float64, cuda)[5]
    tab = clf.table.on(cuda, dtype)
    got = LK.assemble_fold_lean_factored(tab, 0.02, 1.3)
    ref = LK.assemble_fold_lean_factored_plain(tab, 0.02, 1.3)
    assert got.shape[0] == 135 and float((got - ref).abs().max() / ref.abs().max()) <= tol
    dia = clf.assemble().dia
    data = dia.data.to(dtype).contiguous()
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x = torch.randn(dia.shape[0], generator=g, device=cuda, dtype=dtype)
    n7 = LK.dia_matvec_bs.launches
    y = LK.dia_matvec_bs(data, dia.offsets, dia.vshape, 3, x)
    y_ref = LK.dia_matvec_plain(data, dia.offsets, dia.vshape, 3, x)
    torch.cuda.synchronize()
    assert LK.dia_matvec_bs.launches == n7 + 1
    assert float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref)) <= max(tol, 1e-13)
    # K7's bs=2 instantiation on random planes over the same offsets
    d2 = torch.randn((len(dia.offsets), 2, 2) + dia.vshape, generator=g, device=cuda, dtype=dtype)
    x2 = torch.randn(2 * dia.shape[0] // 3, generator=g, device=cuda, dtype=dtype)
    y2 = LK.dia_matvec_bs(d2, dia.offsets, dia.vshape, 2, x2)
    y2_ref = LK.dia_matvec_plain(d2, dia.offsets, dia.vshape, 2, x2)
    assert float(torch.linalg.vector_norm(y2 - y2_ref) / torch.linalg.vector_norm(y2_ref)) <= max(tol, 1e-13)
    free2 = _free_problem((3, 4, 5), np.float64, cuda, 2)[5]
    for t in (LK.build_fold_table(clf), free2.table, LK.build_fold_table(free2, _refined=True)):
        td = t.on(cuda, dtype)
        n5 = LK.assemble_fold_lean_raw.launches
        got = LK.assemble_fold_lean_raw(td, 0.02)
        ref = LK.assemble_fold_lean_raw_plain(td, 0.02)
        torch.cuda.synchronize()
        assert LK.assemble_fold_lean_raw.launches == n5 + 1
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol


def test_k5_equals_unit_factor_k1_k4_on_card(cuda):
    """K5 on a form without Dirichlet dofs equals K1 / K4 with unit mask
    factors bit for bit, on both layouts."""
    for degree, dims in ((1, (5, 6, 7)), (2, (3, 4, 5))):
        clf = _free_problem(dims, np.float32, cuda, degree)[5]
        if degree == 2:
            keep, ind, pads = clf._keep_blocked, clf._bc_ind_blocked, clf._blocked_pads()
        else:
            keep, ind, pads = clf._keep_grid, clf._bc_ind_grid, None
        unit = LK.build_fold_table(clf, LK._detect_factored_masks(keep, ind, pads), keep, ind)
        k1 = LK.assemble_fold_lean_blocked if degree == 2 else LK.assemble_fold_lean_factored
        n5 = LK.assemble_fold_lean_raw.launches
        data = clf.assemble().dia.data
        assert LK.assemble_fold_lean_raw.launches == n5 + 1
        assert torch.equal(data.reshape(-1), k1(unit.on(cuda, torch.float32), 0.0, 1.0).reshape(-1))


@pytest.mark.parametrize("case", ["elasticity P1 n=4", "free P1 n=6", "free P2 n=3"])
def test_elasticity_and_dirichlet_free_f64_on_card_meet_oracle(cuda, case):
    import scipy.sparse.linalg as spla

    from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix

    if case.startswith("elasticity"):
        V, bcs, mpc, a, L, _ = _elasticity_problem((4, 4, 4), np.float64, cuda)
        counter = LK.dia_matvec_bs
    else:
        degree, n = (1, 6) if "P1" in case else (2, 3)
        V, bcs, mpc, a, L, _ = _free_problem((n, n, n), np.float64, cuda, degree)
        counter = LK.assemble_fold_lean_raw
    n0 = counter.launches
    prob = pt.LinearProblem(a, L, mpc, bcs=bcs,
                            petsc_options={"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12})
    u = prob.solve().x.array
    assert u.device.type == "cuda" and counter.launches > n0
    A = assemble_matrix_scipy(a, bcs)
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [bcs],
                                   device="cpu"), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)
    assert np.abs(u.cpu().numpy() - u_ref).max() < 1e-8
