"""K1 to K8 on the card against their plain PyTorch versions, the general
assembler on the card against the CPU, and the f64 oracles through the
card's kernels.  Marked `cuda`: skipped where there is
no CUDA card (the CPU suite); run on one with
``python -m pytest tests/test_torch_cuda.py -q``."""

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
from dolfinx_mpc_tpu_torch.fem.mesh import create_box
from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
from torch_fold_tables import padded_table

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
    clf = pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold", device=device)
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
    clf = pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold", device=device)
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
    clf = pt.assemble_matrix_lattice(a, mpc, bcs=[], dtype=dtype, side_format="fold", device=device)
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


def _contact_problem(nb, nt, dtype, device):
    """benchmarks/bench_contact_3D.py's tied contact between two stacked P1
    vector boxes (NB^3 and NT^3 cells), with a body force."""
    from dolfinx_mpc_tpu_torch.fem.mesh import Mesh, meshtags

    bot = create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                bot.cell_type)
    V = pt.functionspace(mesh, ("Lagrange", 1, (3,)))
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts][:, :, 2], 1.0).all(axis=1)
    iface = np.flatnonzero(on_iface & np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets()))
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    mpc = pt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_contact_inelastic_condition(meshtags(mesh, 2, iface, np.where(cz > 1.0, 1, 2)), 1, 2)
    mpc.finalize()
    bcs = [pt.dirichletbc(np.zeros(3), pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V),
           pt.dirichletbc(np.array([0.0, 0.0, -0.05]),
                          pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 2.0)), V)]
    a = pt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)))
    L = pt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[2]) * v.value[..., 0]
                      + 0.5 * c.x[1] * v.value[..., 1] - v.value[..., 2])
    return V, bcs, mpc, a, L


def _edge_rows_matrix(rng):
    """101 x 1000 with empty rows (40-49, 100), a row held only by the
    remainder under mt_cap=1 (row 9: far tiles only) and n_rows < nblk * 8
    (13 row blocks rounded up to 16)."""
    import scipy.sparse as sp

    rows, cols = [], []
    for r in range(101):
        if 40 <= r < 50 or r == 100:
            continue
        cs = [400, 700, 900] if r == 9 else [r] + list(rng.integers(max(r - 5, 0), r + 6, 4))
        rows += [r] * len(cs)
        cols += cs
    return sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)), shape=(101, 1000)).tocsr()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_k8_matches_plain_on_card(cuda, dtype, tol):
    """K8 on the packed layout against its plain version and against the
    tile product + remainder, on a mesh-like matrix with dense rows, on the
    same matrix with mt_cap=2 (most of it in the COO remainder), on empty
    rows / remainder-only rows / n_rows < nblk*8, and on an assembled
    contact operator; BellMatrix.matvec is one K8 launch and matches scipy."""
    import scipy.sparse as sp

    from dolfinx_mpc_tpu_torch.la import bell as BL

    rng = np.random.default_rng(0)
    n = 1000
    rows = np.repeat(np.arange(n), 11)
    cols = np.clip(rows + rng.integers(-40, 41, rows.shape[0]), 0, n - 1)
    dense = np.repeat(rng.choice(n, 2, replace=False), n // 3)
    A = sp.coo_matrix((rng.standard_normal(rows.shape[0] + dense.shape[0]),
                       (np.concatenate([rows, dense]), np.concatenate([cols, rng.integers(0, n, dense.shape[0])]))),
                      shape=(n, n)).tocsr()
    V, bcs, mpc, a, _ = _contact_problem(4, 3, np.float64, "cpu")
    C = pt.assemble_matrix(a, mpc, bcs).to_scipy()
    ndt = np.float32 if dtype == torch.float32 else np.float64
    for M, kw in ((A, {}), (A, {"mt_cap": 2}), (_edge_rows_matrix(rng), {"mt_cap": 1}), (C, {})):
        B = BL.bell_from_scipy(M, dtype=ndt, device=cuda, **kw)
        assert B.packed is not None and B.packed.device.type == "cuda"
        x = torch.as_tensor(rng.standard_normal(M.shape[1]).astype(ndt), device=cuda)
        n8 = BL.bell_matvec.launches
        y = BL.bell_matvec(B, x)
        y_ref = BL.bell_packed_matvec_plain(B.packed, x)
        torch.cuda.synchronize()
        assert BL.bell_matvec.launches == n8 + 1
        assert float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref)) <= tol
        tiles = BL.bell_matvec_plain(B.data, B.cols, x, M.shape[0]).index_add_(
            0, B.rem_rows, B.rem_data * x[B.rem_cols])
        assert float(torch.linalg.vector_norm(y - tiles) / torch.linalg.vector_norm(tiles)) <= tol
        if "mt_cap" in kw and M.shape[0] == 101:
            yc = y.cpu().numpy()
            assert (yc[40:50] == 0).all() and yc[100] == 0 and yc[9] != 0
        ys = B.matvec(x)
        assert BL.bell_matvec.launches == n8 + 2
        y_sp = M @ x.cpu().numpy().astype(np.float64)
        assert np.linalg.norm(ys.cpu().numpy() - y_sp) / np.linalg.norm(y_sp) <= max(tol, 1e-12) * 10
    with pytest.raises(TypeError):
        BL.bell_matvec(B, x.to(torch.float64 if dtype == torch.float32 else torch.float32))
    with pytest.raises(RuntimeError):
        BL.bell_matvec(B, x.cpu())


@pytest.mark.parametrize("ndt", [np.float32, np.float64], ids=["f32", "f64"])
def test_bell_plan_hit_equals_a_miss_on_card(cuda, ndt):
    """The contact operator assembled on the card twice, with other Lame
    parameters: the second conversion is a plan hit, and its BellMatrix
    equals a conversion of the same matrix with no plan in every array, bit
    for bit, the packed layout K8 reads included; K8's y on both is the
    same bit for bit.  A plan made on the CPU serves no conversion on the
    card."""
    from dolfinx_mpc_tpu_torch.la import bell as BL
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    def hits():
        return tt.trace_timings().get("bell.plan_hit", (0,))[0]

    V, bcs, mpc, _, _ = _contact_problem(6, 5, np.float64, cuda)
    consts = {"mu": 1.0, "lam": 1.25}
    a = pt.BilinearForm(V, lambda u, v, c: 2 * c["mu"] * inner(sym(grad(u)), sym(grad(v)))
                        + c["lam"] * div(u) * conj(div(v)), constants=consts)
    BL._plans.clear()
    A1 = pt.assemble_matrix(a, mpc, bcs).to_scipy()
    BL.bell_from_scipy(A1, dtype=ndt, device="cpu")
    BL.bell_from_scipy(A1, dtype=ndt, device=cuda)
    consts["mu"], consts["lam"] = 1.1, 1.0
    A2 = pt.assemble_matrix(a, mpc, bcs).to_scipy()
    assert np.array_equal(A1.indptr, A2.indptr) and np.array_equal(A1.indices, A2.indices)
    assert not np.array_equal(A1.data, A2.data)
    h0 = hits()
    hit = BL.bell_from_scipy(A2, dtype=ndt, device=cuda)
    assert hits() == h0 + 1
    BL._plans.clear()
    miss = BL.bell_from_scipy(A2, dtype=ndt, device=cuda)
    assert hits() == h0 + 1 and hit.data.device.type == "cuda" and hit.rem_data.shape[0] > 0
    for name in ("data", "cols", "diag", "rem_data", "rem_rows", "rem_cols"):
        h, m = getattr(hit, name).cpu().numpy(), getattr(miss, name).cpu().numpy()
        assert h.dtype == m.dtype and h.shape == m.shape and h.tobytes() == m.tobytes(), name
    for name in ("row_ptr", "cols", "vals"):
        assert torch.equal(getattr(hit.packed, name), getattr(miss.packed, name)), name
    assert hit.packed.threads_per_row == miss.packed.threads_per_row
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    x = torch.randn(A2.shape[1], generator=g, device=cuda, dtype=getattr(torch, np.dtype(ndt).name))
    y_hit, y_miss = BL.bell_matvec(hit, x), BL.bell_matvec(miss, x)
    assert y_hit.cpu().numpy().tobytes() == y_miss.cpu().numpy().tobytes()
    BL._plans.clear()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-13)])
def test_k2_matches_plain_on_card_grids(cuda, dtype, tol):
    """K2 (the prepared launch DIAMatrix.matvec keeps) against its plain
    version on the P1 15-offset stencil over 9^3, 17^3, 33^3 and a ragged
    7 x 13 x 70 grid, and on the 65-offset refined P2 DIA (|d| <= 2) over
    9^3 and 7 x 13 x 70, with random planes; one launch per matvec."""
    from dolfinx_mpc_tpu_torch.ops.lattice import DIAMatrix

    p1 = _problem((2, 2, 2), np.float64, "cpu")[5].offsets
    p2 = _problem((2, 2, 2), np.float64, "cpu", degree=2)[5].offsets
    assert len(p1) == 15 and len(p2) == 65
    rng = np.random.default_rng(1)
    for offs, grids in ((p1, ((9, 9, 9), (17, 17, 17), (33, 33, 33), (7, 13, 70))),
                        (p2, ((9, 9, 9), (7, 13, 70)))):
        for vshape in grids:
            data = torch.as_tensor(rng.standard_normal((len(offs), 1, 1) + vshape), device=cuda).to(dtype)
            x = torch.as_tensor(rng.standard_normal(int(np.prod(vshape))), device=cuda).to(dtype)
            dia = DIAMatrix(data, offs, vshape, 1)
            n2 = LK.dia_matvec.launches
            y = dia.matvec(x)
            y2 = dia.matvec(x)
            torch.cuda.synchronize()
            assert LK.dia_matvec.launches == n2 + 2 and torch.equal(y, y2)
            y_ref = LK.dia_matvec_plain(data, offs, vshape, 1, x)
            rel = float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref))
            assert rel <= tol, (len(offs), vshape, rel)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-13)])
def test_k7_matches_plain_on_card_grids(cuda, dtype, tol):
    """K7 (the prepared launch DIAMatrix.matvec keeps at bs > 1) against its
    plain version on the P1 15-offset stencil at bs 2 and 3 over 9^3, 17^3,
    33^3 and a ragged 7 x 13 x 70 grid, with random planes; one launch per
    matvec, counted under its grid, and two calls bit-equal."""
    from dolfinx_mpc_tpu_torch.ops.lattice import DIAMatrix

    offs = _problem((2, 2, 2), np.float64, "cpu")[5].offsets
    rng = np.random.default_rng(2)
    for bs in (2, 3):
        for vshape in ((9, 9, 9), (17, 17, 17), (33, 33, 33), (7, 13, 70)):
            data = torch.as_tensor(rng.standard_normal((len(offs), bs, bs) + vshape), device=cuda).to(dtype)
            x = torch.as_tensor(rng.standard_normal(bs * int(np.prod(vshape))), device=cuda).to(dtype)
            dia = DIAMatrix(data, offs, vshape, bs)
            n7, g7 = LK.dia_matvec_bs.launches, LK.dia_matvec_bs.launches_by_grid.get(vshape, 0)
            y = dia.matvec(x)
            y2 = dia.matvec(x)
            torch.cuda.synchronize()
            assert LK.dia_matvec_bs.launches == n7 + 2 and torch.equal(y, y2)
            assert LK.dia_matvec_bs.launches_by_grid[vshape] == g7 + 2
            y_ref = LK.dia_matvec_plain(data, offs, vshape, bs, x)
            rel = float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref))
            assert rel <= tol, (bs, vshape, rel)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-13)])
def test_k6_matches_plain_on_card_grids(cuda, dtype, tol):
    """K6 (the prepared launch BlockDIAMatrix.matvec_blocked keeps) against
    its plain version with the 230 P2 triples over 8 x 9^3 and 8 x 33^3
    class grids and on a ragged 8 x 5 x 7 x 70 stack with the body class's
    triples left out (its output is 0), with random planes; one launch per
    matvec, two calls bit-equal."""
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix

    trips = _problem((2, 2, 2), np.float64, "cpu", degree=2)[5].trips
    assert len(trips) == 230
    rng = np.random.default_rng(3)
    for cdims, tr in (((9, 9, 9), trips), ((33, 33, 33), trips),
                      ((5, 7, 70), [t for t in trips if t[0] != (1, 1, 1)])):
        vshape = tuple(2 * s - 1 for s in cdims)
        data = torch.as_tensor(rng.standard_normal((len(tr),) + cdims), device=cuda).to(dtype)
        dia = BlockDIAMatrix(data, tr, vshape, (2, 2, 2))
        xb = torch.as_tensor(rng.standard_normal((8,) + cdims), device=cuda).to(dtype)
        n6 = LK.blocked_matvec.launches
        y = dia.matvec_blocked(xb)
        y2 = dia.matvec_blocked(xb)
        torch.cuda.synchronize()
        assert LK.blocked_matvec.launches == n6 + 2 and torch.equal(y, y2)
        y_ref = LK.blocked_matvec_plain(data, tr, dia.classes, xb)
        rel = float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref))
        assert rel <= tol, (cdims, len(tr), rel)
        if len(tr) < 230:
            assert not y[dia.classes.index((1, 1, 1))].any()


def test_assemble_matrix_on_card_matches_cpu(cuda):
    """The general assembler on the card against the same assembly on the
    CPU: the same pattern, values within 1e-14 (f64) and 1e-6 (f32)
    relative (atomics change the summation order)."""
    for dtype, tol in ((np.float64, 1e-14), (np.float32, 1e-6)):
        out = {}
        for dev in ("cpu", cuda):
            V, bcs, mpc, a, L = _contact_problem(4, 3, dtype, dev)
            A = pt.assemble_matrix(a, mpc, bcs)
            b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
            assert A.data.device.type == torch.device(dev).type
            out[str(dev)] = (A.to_scipy(), b.cpu().numpy())
        (Ac, bc_), (Ag, bg) = out["cpu"], out["cuda"]
        assert np.array_equal(Ac.indptr, Ag.indptr) and np.array_equal(Ac.indices, Ag.indices)
        assert abs(Ag - Ac).max() <= tol * abs(Ac).max()
        assert np.abs(bg - bc_).max() <= tol * np.abs(bc_).max()


def test_contact_f64_on_card_meets_oracle(cuda):
    """The contact solve on the card in float64, through K8 (BELL + AMG +
    CG) and through LinearProblem with pc gamg (CSR, no K8), against
    K (K^T A K)^-1 K^T b within 1e-8."""
    import scipy.sparse.linalg as spla

    from dolfinx_mpc_tpu_torch.la import bell as BL
    from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    V, bcs, mpc, a, L = _contact_problem(4, 3, np.float64, cuda)
    A0 = pt.assemble_matrix(a, None, bcs, device="cpu").to_scipy()
    b0 = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [bcs]), bcs).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A0 @ K).tocsc(), K.T @ b0)
    A = pt.assemble_matrix(a, mpc, bcs)
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
    As = A.to_scipy()
    B = BL.bell_from_scipy(As, dtype=np.float64, device=cuda)
    M = smoothed_aggregation_amg(As, bs=3, dtype=np.float64, nullspace=rigid_motions_nullspace(V), device=cuda)
    n8 = BL.bell_matvec.launches
    x, its, _ = pt.cg(B.matvec, b, M=M, rtol=1e-12, atol=0.0, max_it=500)
    u = mpc.finalized.backsubstitution(x)
    assert BL.bell_matvec.launches == n8 + its + 1
    assert np.abs(u.cpu().numpy() - u_ref).max() < 1e-8
    n8 = BL.bell_matvec.launches
    prob = pt.LinearProblem(a, L, mpc, bcs=bcs, petsc_options={"ksp_type": "cg", "pc_type": "gamg",
                                                                "ksp_rtol": 1e-12})
    ug = prob.solve().x.array
    assert ug.device.type == "cuda" and BL.bell_matvec.launches == n8
    assert np.abs(ug.cpu().numpy() - u_ref).max() < 1e-8


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_fold_assemblers_match_plain_on_card_odd_extents(cuda, dtype, tol):
    """K1 (P1 and bs=3), K4 (P2, also on class grids padded beyond n + 1)
    and K3 (P1 and P2 with the non-separable set, P2 also padded) against
    their plain versions at odd, unequal extents, through the tables'
    prepared launches with plain and with evict-first stores (K3 also with
    its keep planes read from the L2 instead of staged): one launch per
    call, two calls bit-equal, every padded slot an exact 0."""
    p2 = _problem((3, 4, 5), np.float64, "cpu", degree=2)[5].table
    b2 = _problem((3, 4, 5), np.float64, "cpu", degree=2, marker=_blob)[5].table
    cases = [(LK.assemble_fold_lean_factored, _problem((7, 9, 11), np.float64, "cpu")[5].table),
             (LK.assemble_fold_lean_factored, _elasticity_problem((5, 6, 7), np.float64, "cpu")[5].table),
             (LK.assemble_fold_lean_blocked, p2), (LK.assemble_fold_lean_blocked, padded_table(p2, (2, 1, 0))),
             (LK.assemble_fold_lean_masked, _problem((5, 6, 7), np.float64, "cpu", marker=_blob)[5].table),
             (LK.assemble_fold_lean_masked, b2), (LK.assemble_fold_lean_masked, padded_table(b2, (0, 2, 1)))]
    for kernel, table in cases:
        masked = kernel is LK.assemble_fold_lean_masked
        tab = table.on(cuda, dtype)
        plain = LK.assemble_fold_lean_masked_plain if masked else LK.assemble_fold_lean_factored_plain
        ref = plain(tab, 0.02, 1.3)
        params = (tab.launch("masked") if masked else tab.launch("factored", table.blocked)).params
        for stream, stage in ((0, params.stage), (1, params.stage)) + (((1, 0),) if masked else ()):
            params.stream, params.stage = stream, stage
            n = kernel.launches
            got, again = kernel(tab, 0.02, 1.3), kernel(tab, 0.02, 1.3)
            torch.cuda.synchronize()
            assert kernel.launches == n + 2 and torch.equal(got, again)
            assert float((got - ref).abs().max() / ref.abs().max()) <= tol, (kernel.__name__, table.vshape, stream,
                                                                            stage)
        if table.blocked:
            rows = torch.as_tensor(table.planes[:, 0], device=cuda).long()
            if masked:
                real = torch.as_tensor(table.keep[:, 1:-1, 1:-1, 1:-1] + table.bc_ind, device=cuda)[rows] != 0
            else:
                pi, pj, pk = (torch.as_tensor(f[:, 1:-1], device=cuda) for f in table.factors[3:])
                real = (pi[:, :, None, None] * pj[:, None, :, None] * pk[:, None, None, :])[rows] != 0
            assert not got[~real].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
def test_k5_matches_plain_on_card_odd_extents(cuda, dtype, tol):
    """K5 against its plain version at odd, unequal extents: at stride 1 on
    the raw bs=3 grid table and the raw blocked P2 table (also padded
    beyond n + 1), at stride 2 on the refined P2 table (also padded),
    through the tables' prepared launches with plain and with evict-first
    stores: one launch per call, two calls bit-equal; at stride 1 equal to
    K1 / K4 with unit mask factors bit for bit."""
    el = _elasticity_problem((5, 6, 7), np.float64, "cpu")[5]
    free2 = _free_problem((3, 4, 5), np.float64, "cpu", 2)[5]
    ones3 = np.ones((3,) + el.vshape)
    keep2 = free2._split_classes(np.ones(free2.vshape))
    raw3, refined = LK.build_fold_table(el), LK.build_fold_table(free2, _refined=True)
    unit = {id(raw3): (LK.assemble_fold_lean_factored,
                       LK.build_fold_table(el, LK._detect_factored_masks(ones3, 0 * ones3), ones3, 0 * ones3)),
            id(free2.table): (LK.assemble_fold_lean_blocked,
                              LK.build_fold_table(free2, LK._detect_factored_masks(keep2, 0 * keep2,
                                                                                   free2._blocked_pads()),
                                                  keep2, 0 * keep2))}
    for table in (raw3, free2.table, padded_table(free2.table, (2, 1, 0)), refined, padded_table(refined, (1, 2, 0))):
        tab = table.on(cuda, dtype)
        ref = LK.assemble_fold_lean_raw_plain(tab, 0.02)
        params = tab.launch("raw").params
        assert type(params) is (LK.FoldParamsR2 if table.refine == 2 else LK.FoldParams)
        for stream in (params.stream, 1 - params.stream):
            params.stream = stream
            n = LK.assemble_fold_lean_raw.launches
            got, again = LK.assemble_fold_lean_raw(tab, 0.02), LK.assemble_fold_lean_raw(tab, 0.02)
            torch.cuda.synchronize()
            assert LK.assemble_fold_lean_raw.launches == n + 2 and torch.equal(got, again)
            assert float((got - ref).abs().max() / ref.abs().max()) <= tol, (table.vshape, table.refine, stream)
        if id(table) in unit:
            kernel, u = unit[id(table)]
            assert torch.equal(got, kernel(u.on(cuda, dtype), 0.02, 1.3))


def _facet_forms(device):
    """P2 tets: stiffness plus g u v + (n . grad u) v on the x=1 facets (g
    from a seed), a facet source with n, a general constraint and a
    Dirichlet value at z=0."""
    from dolfinx_mpc_tpu_torch.fem.forms import dot
    from dolfinx_mpc_tpu_torch.fem.mesh import locate_entities_boundary

    mesh = create_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (3, 2, 2))
    V = pt.functionspace(mesh, ("Lagrange", 2))
    g = pt.Function(V, np.random.default_rng(11).uniform(0.5, 1.5, V.num_dofs), name="g", device=device)
    facets = locate_entities_boundary(mesh, 2, lambda x: np.isclose(x[0], 1.0))
    a = pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v))) + pt.BilinearForm(
        V, lambda u, v, c: c["g"].value * inner(u, v) + dot(c.n, grad(u)) * v.value,
        integral="exterior_facet", entities=facets, coefficients={"g": g})
    L = pt.LinearForm(V, lambda v, c: (2.0 + c.x[1] + c.n[0]) * v.value, integral="exterior_facet",
                      entities=facets)
    mpc = pt.MultiPointConstraint(V, np.float64, device=device)
    mpc.create_general_constraint({np.array([1.0, 0.5, 0.5]).tobytes(): {np.array([0.0, 0.5, 0.5]).tobytes(): 0.7}})
    mpc.finalize()
    bc = pt.dirichletbc(0.25, pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V)
    return a, L, mpc, bc


def test_facet_assembly_on_card_matches_cpu(cuda):
    """Exterior-facet matrix, vector and lifting assembled on the card equal
    the CPU's in float64 within 1e-12 relative (atomics reorder sums)."""
    out = {}
    for dev in ("cpu", cuda):
        a, L, mpc, bc = _facet_forms(dev)
        A = pt.assemble_matrix(a, mpc, [bc])
        b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, mpc), [a], [[bc]], mpc), [bc])
        assert A.data.device.type == b.device.type == torch.device(dev).type
        out[str(dev)] = (A.to_scipy(), b.cpu().numpy())
    (Ac, bc_), (Ag, bg) = out["cpu"], out["cuda"]
    assert np.array_equal(Ac.indptr, Ag.indptr) and np.array_equal(Ac.indices, Ag.indices)
    assert abs(Ag - Ac).max() <= 1e-12 * abs(Ac).max()
    assert np.abs(bg - bc_).max() <= 1e-12 * np.abs(bc_).max()


def test_rotated_slip_contact_on_card_meets_oracle(cuda):
    """chip_smoke.make_slip_contact at NB=3/NT=2 on the card (projected
    normal by exterior-facet assembly and Jacobi-CG on the card, the
    traction as a facet term), solved in float64 by LinearProblem:
    K (K^T A K)^-1 K^T b within 1e-8, and the projected normal equal to the
    averaged one within 1e-8."""
    import os
    import sys

    import scipy.sparse.linalg as spla

    from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    import chip_smoke

    times = {}
    V, bcs, mpc, a, L = chip_smoke.make_slip_contact(3, 2, np.float64, cuda, times)
    assert times["normal_gap"] <= 1e-8 and mpc.num_local_slaves > 0
    u = pt.LinearProblem(a, L, mpc, bcs=bcs, petsc_options={"ksp_rtol": 1e-12}).solve().x.array
    assert u.device.type == "cuda"
    A0 = assemble_matrix_scipy(a, bcs)
    b0 = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [bcs], None, device="cpu"),
                   bcs).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A0 @ K).tocsc(), K.T @ b0)
    assert np.abs(u.cpu().numpy() - u_ref).max() < 1e-8


def _solver_system(device):
    """tests/test_torch_krylov.py's 8 x 8 periodic system on `device`."""
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square

    V = pt.functionspace(create_unit_square(8, 8), ("Lagrange", 1))
    bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
    mpc = pt.MultiPointConstraint(V, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)) + inner(u, v))
    return pt.assemble_matrix(a, mpc, bcs=[bc])


@pytest.mark.parametrize("ksp", ["bcgs", "gmres"])
def test_krylov_on_card_matches_cpu(cuda, ksp):
    """bicgstab / gmres with Chebyshev (one probe) on the card: the CPU
    iterate to 1e-10 relative, the count within 2 (another summation
    order), the Krylov basis and x on the card."""
    from dolfinx_mpc_tpu_torch.la import solvers as S

    b = np.random.default_rng(2).standard_normal(_solver_system("cpu").shape[0])
    probe = np.random.default_rng(5).standard_normal(b.shape[0])
    out = {}
    for dev in ("cpu", cuda):
        A = _solver_system(dev)
        M = S.chebyshev_preconditioner(A.matvec, A.diagonal(), probe=probe)
        fn = S.bicgstab if ksp == "bcgs" else S.gmres
        x, its, _ = fn(A.matvec, torch.as_tensor(b, device=dev), M=M, rtol=1e-12, max_it=5000)
        assert x.device.type == torch.device(dev).type
        out[str(dev)] = (x.cpu().numpy(), its)
    (xc, ic), (xg, ig) = out["cpu"], out[str(cuda)]
    assert abs(ic - ig) <= 2 and np.abs(xg - xc).max() <= 1e-10 * np.abs(xc).max()


def test_eigsh_on_card_matches_cpu(cuda):
    """The shift-and-invert eigensolver on CSR operators on the card: the
    CPU eigenvalues to 1e-8 relative."""
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square
    from dolfinx_mpc_tpu_torch.la import eigsh_shift_invert, jacobi_preconditioner

    lams = []
    for dev in ("cpu", cuda):
        V = pt.functionspace(create_unit_square(10, 10), ("Lagrange", 1))
        bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                            | np.isclose(x[1], 1.0)), V)
        mpc = pt.MultiPointConstraint(V, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
        mpc.finalize()
        K = pt.assemble_matrix(pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v))), mpc, bcs=[bc],
                               diagval=1e4)
        M = pt.assemble_matrix(pt.BilinearForm(V, lambda u, v, c: inner(u, v)), mpc, bcs=[bc])
        lam, U, _ = eigsh_shift_invert(K, M, 3, pc=jacobi_preconditioner(K.diagonal()), tol=1e-9)
        assert U.device.type == torch.device(dev).type
        lams.append(np.sort(lam))
    assert np.allclose(lams[1], lams[0], rtol=1e-8, atol=0)


def test_eigsh_on_card_matrix_free_and_callable(cuda):
    """eigsh_shift_invert without X0 on a MatrixFreeKTAK on the card (no
    .data tensor: the start block follows its .device) and on plain
    callables of card tensors (no device given: the card by default): the
    CSR pencil's eigenvalues on the CPU to 1e-8 relative, vectors on the
    card."""
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square
    from dolfinx_mpc_tpu_torch.la import eigsh_shift_invert, jacobi_preconditioner
    from dolfinx_mpc_tpu_torch.ops.matfree import MatrixFreeKTAK

    out = {}
    for dev in ("cpu", cuda):
        V = pt.functionspace(create_unit_square(10, 10), ("Lagrange", 1))
        bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                            | np.isclose(x[1], 1.0)), V)
        mpc = pt.MultiPointConstraint(V, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
        mpc.finalize()
        k_form = pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
        K = pt.assemble_matrix(k_form, mpc, bcs=[bc], diagval=1e4)
        M = pt.assemble_matrix(pt.BilinearForm(V, lambda u, v, c: inner(u, v)), mpc, bcs=[bc])
        pc = jacobi_preconditioner(K.diagonal())
        out[str(dev)] = eigsh_shift_invert(K, M, 3, pc=pc, tol=1e-9)
        if dev == cuda:
            op = MatrixFreeKTAK(k_form, mpc, bcs=[bc], diagval=1e4)
            out["mf"] = eigsh_shift_invert(op, M, 3, pc=jacobi_preconditioner(op.diagonal()), tol=1e-9)
            X0 = np.random.default_rng(0).standard_normal((V.num_dofs, 6))
            out["callable"] = eigsh_shift_invert(K.matvec, M.matvec, 3, X0=X0, pc=pc, tol=1e-9)
    lam = np.sort(out["cpu"][0])
    for key in ("mf", "callable"):
        assert out[key][1].device.type == "cuda"
        assert np.allclose(np.sort(out[key][0]), lam, rtol=1e-8, atol=0)


def test_nest_matvec_through_k8_on_card(cuda):
    """demo_stokes_nest's nest at 8 x 4 as BELL blocks on the card: one K8
    launch per block matvec, equal to the CSR nest product to 1e-12; the
    BiCGStab solve on BELL blocks launches K8 3 + 21 + 16 per iteration and
    holds the slip wall to 1e-8."""
    from dolfinx_mpc_tpu_torch.demos import demo_stokes_nest
    from dolfinx_mpc_tpu_torch.la.bell import bell_matvec

    pb = demo_stokes_nest.problem(8, 4, device=cuda)
    Ab = pb.A.to_bell()
    x = torch.randn(pb.rhs.shape[0], dtype=torch.float64, device=cuda)
    n0 = bell_matvec.launches
    y = Ab.matvec(x)
    torch.cuda.synchronize()
    assert bell_matvec.launches == n0 + 3
    y_ref = pb.A.matvec(x)
    assert float((y - y_ref).abs().max()) <= 1e-12 * float(y_ref.abs().max())
    from dolfinx_mpc_tpu_torch.la.solvers import bicgstab

    n0 = bell_matvec.launches
    M = demo_stokes_nest.preconditioner(Ab, pb.mass_q, np.random.default_rng(0).standard_normal(pb.V.num_dofs))
    x, its, _ = bicgstab(Ab.matvec, pb.rhs, M=M, rtol=1e-10, max_it=4000)
    torch.cuda.synchronize()
    assert bell_matvec.launches == n0 + 3 + 21 + 16 * its
    u = pb.mpc.finalized.backsubstitution(x[: pb.V.num_dofs]).cpu().numpy().reshape(-1, 2)
    nvals = pb.nh.x.array.cpu().numpy().reshape(-1, 2)
    sb = np.unique(pb.mpc.slaves // 2)
    assert np.abs((u[sb] * nvals[sb]).sum(1)).max() < 1e-8


def test_newton_step_on_card(cuda):
    """NonlinearProblem on tests/test_nonlinear.py's periodic problem on the
    card: the CPU's Newton count and solution (1e-10)."""
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_square

    out = []
    for dev in ("cpu", cuda):
        V = pt.functionspace(create_unit_square(8, 8), ("Lagrange", 1))
        bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                            | np.isclose(x[1], 1.0)), V)
        mpc = pt.MultiPointConstraint(V, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
        mpc.finalize()
        u = pt.Function(V, name="u", device=dev)
        F = pt.LinearForm(V, lambda v, c: inner((1 + c["u"].value ** 2) * grad(c["u"]), grad(v)) - 4.0 * v.value,
                          coefficients={"u": u})
        its, converged = pt.NonlinearProblem(F, u, mpc, bcs=[bc]).solve()
        assert converged and u.x.array.device.type == torch.device(dev).type
        out.append((its, u.x.array.cpu().numpy()))
    assert out[0][0] == out[1][0] and np.abs(out[0][1] - out[1][1]).max() <= 1e-10


def test_lattice_krylov_on_card_launches_k1_k2(cuda):
    """LinearProblem with bcgs + Chebyshev on the P1 lattice problem (n=8)
    on the card: K1 assembles, K2 serves every matvec, the CPU count
    within 2 and solution to 1e-8."""
    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LKm

    out = []
    for dev in ("cpu", cuda):
        V, bc, mpc, a, L, _ = _problem((8, 8, 8), np.float64, dev)
        prob = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={
            "ksp_type": "bcgs", "pc_type": "chebyshev", "ksp_rtol": 1e-10})
        prob.options.cheb_probe = np.random.default_rng(0).standard_normal(V.num_dofs)
        n1, n2 = LKm.assemble_fold_lean_factored.launches, LKm.dia_matvec.launches
        u = prob.solve().x.array
        if dev != "cpu":
            torch.cuda.synchronize()
            assert LKm.assemble_fold_lean_factored.launches > n1 and LKm.dia_matvec.launches > n2
        out.append((prob.its, u.cpu().numpy()))
    assert abs(out[0][0] - out[1][0]) <= 2 and np.abs(out[0][1] - out[1][1]).max() <= 1e-8


def _lattice_case(case, device, side_format="fold"):
    """The element-kernel lattice operators of the 2-D and refined grids:
    2-D P1 (K2 at n2 = 1), 2-D vector P1 (K7 at bs = 2, n2 = 1), 2-D P2 on
    the parity-blocked layout (K6 at s2 = 1) and 3-D vector P2 on the
    refined grid (K7 at 65 offsets, halo 2), periodic in x, Dirichlet on
    y = 0, float64."""
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube, create_unit_square

    degree, bs, make = {"K2 2-D": (1, None, lambda: create_unit_square(9, 7)),
                        "K7 2-D bs=2": (1, 2, lambda: create_unit_square(9, 7)),
                        "K6 2-D P2": (2, None, lambda: create_unit_square(6, 5)),
                        "K7 P2 bs=3": (2, 3, lambda: create_unit_cube(3, 3, 2))}[case]
    mesh = make()
    V = pt.functionspace(mesh, ("Lagrange", degree, (bs,)) if bs else ("Lagrange", degree))
    g = mesh.gdim
    bc = pt.dirichletbc(np.zeros(bs) if bs else 0.0, pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)),
                        V)
    mpc = pt.MultiPointConstraint(V, np.float64, device=device)
    rel = (lambda x: np.stack([1.0 - x[0], x[1]])) if g == 2 else (lambda x: np.stack([1.0 - x[0], x[1], x[2]]))
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0), rel, [bc])
    mpc.finalize()
    if bs:
        a = pt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)),
                            quad_degree=2)
    else:
        a = pt.BilinearForm(V, lambda u, v, c: (1.0 + c.x[0] * c.x[1]) * inner(grad(u), grad(v)), quad_degree=2)
    return pt.assemble_matrix_lattice(a, mpc, bcs=[bc], side_format=side_format, device=device).assemble()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6), (torch.float64, 1e-12)])
@pytest.mark.parametrize("case", ["K2 2-D", "K7 2-D bs=2", "K6 2-D P2", "K7 P2 bs=3"])
def test_lattice_spmvs_on_new_grids_match_plain_on_card(cuda, case, dtype, tol):
    """K2 and K7 on grids with n2 = 1, K6 with s2 = 1 and K7 with the
    refined grid's 65 offsets against their plain versions, one launch
    each, on operators the element-kernel lean path assembled on the card
    (equal to the CPU's)."""
    A = _lattice_case(case, cuda)
    A_cpu = _lattice_case(case, "cpu")
    assert float((A.dia.data.cpu() - A_cpu.dia.data).abs().max()) <= 1e-12 * float(A_cpu.dia.data.abs().max())
    data = A.dia.data.to(dtype).contiguous()
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    if case == "K6 2-D P2":
        assert A.dia.cdims[2] == 1 and len(A.dia.classes) == 4
        x = torch.randn((4,) + A.dia.cdims, generator=g, device=cuda, dtype=torch.float64).to(dtype)
        counter, n0 = LK.blocked_matvec, LK.blocked_matvec.launches
        y = LK.blocked_matvec(data, A.dia.trips, A.dia.classes, x)
        y_ref = LK.blocked_matvec_plain(data, A.dia.trips, A.dia.classes, x)
    else:
        dia = A.dia
        assert dia.vshape[2] == 1 or len(dia.offsets) == 65
        x = torch.randn(dia.shape[0], generator=g, device=cuda, dtype=torch.float64).to(dtype)
        counter = LK.dia_matvec if dia.bs == 1 else LK.dia_matvec_bs
        n0 = counter.launches
        y = (LK.dia_matvec(data, dia.offsets, dia.vshape, x) if dia.bs == 1
             else LK.dia_matvec_bs(data, dia.offsets, dia.vshape, dia.bs, x))
        y_ref = LK.dia_matvec_plain(data, dia.offsets, dia.vshape, dia.bs, x)
    torch.cuda.synchronize()
    assert counter.launches == n0 + 1
    assert float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref)) <= tol


@pytest.mark.parametrize("side_format", ["csr", "cells"])
def test_side_formats_on_card_match_cpu(cuda, side_format):
    """The "csr" and "cells" operators assembled on the card: their side
    products (gather, product, index_add_) and diagonals equal the CPU's to
    float64 rounding, and the DIA part runs K2."""
    ops = {}
    for dev in (cuda, "cpu"):
        V, bc, mpc, a, L, _ = _problem((5, 6, 7), np.float64, dev)
        ops[str(dev)] = pt.assemble_matrix_lattice(a, mpc, bcs=[bc], side_format=side_format, device=dev).assemble()
    A, A_cpu = ops[str(cuda)], ops["cpu"]
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(A.shape[0]))
    n2 = LK.dia_matvec.launches
    y = A.matvec(x.to(cuda))
    assert LK.dia_matvec.launches == n2 + 1
    y_ref = A_cpu.matvec(x)
    assert float((y.cpu() - y_ref).abs().max()) <= 1e-13 * float(y_ref.abs().max())
    assert float((A.diagonal().cpu() - A_cpu.diagonal()).abs().max()) <= 1e-13 * float(A_cpu.diagonal().abs().max())


COMPLEX = [(torch.complex64, 5e-6), (torch.complex128, 1e-12)]


def _crandn(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("dtype,tol", COMPLEX, ids=["c64", "c128"])
def test_complex_k2_k7_match_plain_on_card(cuda, dtype, tol):
    """K2 (the P1 15-offset and the refined P2 65-offset stencils) and K7
    (bs 2 and 3 on the P1 stencil, bs 3 at 65 offsets) in complex64 and
    complex128 against the plain version on complex random planes over
    9^3, 33^3 and a ragged 7 x 13 x 70 grid (odd rows: no 16-byte
    alignment for the 8-byte c64 values); one launch per matvec, two calls
    bit-equal."""
    from dolfinx_mpc_tpu_torch.ops.lattice import DIAMatrix

    p1 = _problem((2, 2, 2), np.float64, "cpu")[5].offsets
    p2 = _problem((2, 2, 2), np.float64, "cpu", degree=2)[5].offsets
    rng = np.random.default_rng(4)
    for offs, bs, grids in ((p1, 1, ((9, 9, 9), (33, 33, 33), (7, 13, 70))), (p2, 1, ((9, 9, 9), (7, 13, 70))),
                            (p1, 2, ((9, 9, 9), (7, 13, 70))), (p1, 3, ((9, 9, 9), (33, 33, 33), (7, 13, 70))),
                            (p2, 3, ((9, 9, 9),))):
        counter = LK.dia_matvec if bs == 1 else LK.dia_matvec_bs
        for vshape in grids:
            data = torch.as_tensor(_crandn(rng, (len(offs), bs, bs) + vshape), device=cuda).to(dtype)
            x = torch.as_tensor(_crandn(rng, bs * int(np.prod(vshape))), device=cuda).to(dtype)
            dia = DIAMatrix(data, offs, vshape, bs)
            n0 = counter.launches
            y = dia.matvec(x)
            y2 = dia.matvec(x)
            torch.cuda.synchronize()
            assert counter.launches == n0 + 2 and torch.equal(y, y2) and y.dtype == dtype
            y_ref = LK.dia_matvec_plain(data, offs, vshape, bs, x)
            rel = float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref))
            assert rel <= tol, (len(offs), bs, vshape, rel)


@pytest.mark.parametrize("dtype,tol", COMPLEX, ids=["c64", "c128"])
def test_complex_k6_matches_plain_on_card(cuda, dtype, tol):
    """K6 in complex64 and complex128 against its plain version with the 230
    P2 triples over 8 x 9^3 and 8 x 33^3 class grids and a ragged 8 x 5 x 7
    x 70 stack without the body class's triples; complex128 takes 256 plane
    points per block (512 would overflow shared memory).  One launch per
    matvec, two calls bit-equal."""
    from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix

    trips = _problem((2, 2, 2), np.float64, "cpu", degree=2)[5].trips
    rng = np.random.default_rng(5)
    for cdims, tr in (((9, 9, 9), trips), ((33, 33, 33), trips),
                      ((5, 7, 70), [t for t in trips if t[0] != (1, 1, 1)])):
        data = torch.as_tensor(_crandn(rng, (len(tr),) + cdims), device=cuda).to(dtype)
        dia = BlockDIAMatrix(data, tr, tuple(2 * s - 1 for s in cdims), (2, 2, 2))
        xb = torch.as_tensor(_crandn(rng, (8,) + cdims), device=cuda).to(dtype)
        n6 = LK.blocked_matvec.launches
        y = dia.matvec_blocked(xb)
        y2 = dia.matvec_blocked(xb)
        torch.cuda.synchronize()
        assert LK.blocked_matvec.launches == n6 + 2 and torch.equal(y, y2)
        assert dia._launch.params.pts == (256 if dtype == torch.complex128 else 512)
        y_ref = LK.blocked_matvec_plain(data, tr, dia.classes, xb)
        rel = float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref))
        assert rel <= tol, (cdims, len(tr), rel)


@pytest.mark.parametrize("dtype,tol", COMPLEX, ids=["c64", "c128"])
def test_complex_k8_matches_plain_on_card(cuda, dtype, tol):
    """K8 in complex64 and complex128 on the packed layout of a complex
    mesh-like matrix (also with mt_cap=2: most of it in the remainder) and
    of the complex tied-contact operator (NB=4/NT=3), against its plain
    version and scipy; one launch per matvec."""
    import scipy.sparse as sp

    from dolfinx_mpc_tpu_torch.la import bell as BL

    rng = np.random.default_rng(6)
    n = 1000
    rows = np.repeat(np.arange(n), 11)
    cols = np.clip(rows + rng.integers(-40, 41, rows.shape[0]), 0, n - 1)
    A = sp.coo_matrix((_crandn(rng, rows.shape[0]), (rows, cols)), shape=(n, n)).tocsr()
    V, bcs, mpc, a, _ = _contact_problem(4, 3, np.complex128, "cpu")
    C = pt.assemble_matrix(a, mpc, bcs).to_scipy()
    ndt = np.complex64 if dtype == torch.complex64 else np.complex128
    for M, kw in ((A, {}), (A, {"mt_cap": 2}), (C, {})):
        B = BL.bell_from_scipy(M, dtype=ndt, device=cuda, **kw)
        assert B.packed.vals.dtype == dtype
        x = torch.as_tensor(_crandn(rng, M.shape[1]).astype(ndt), device=cuda)
        n8 = BL.bell_matvec.launches
        y = B.matvec(x)
        torch.cuda.synchronize()
        assert BL.bell_matvec.launches == n8 + 1
        y_ref = BL.bell_packed_matvec_plain(B.packed, x)
        assert float(torch.linalg.vector_norm(y - y_ref) / torch.linalg.vector_norm(y_ref)) <= tol
        y_sp = M @ x.cpu().numpy().astype(np.complex128)
        assert np.linalg.norm(y.cpu().numpy() - y_sp) / np.linalg.norm(y_sp) <= 10 * max(tol, 1e-12)


@pytest.mark.parametrize("backend,n_ranks", [("nccl", 1), ("gloo", 2)], ids=["nccl-1", "gloo-2-sharing"])
def test_distributed_paths_on_card_match_plain(cuda, backend, n_ranks):
    """The sharded lattice path (K2 at bs = 1, K7 at bs = 3) and the general
    path (K8 on each rank's row block) on ranks with their tensors on the
    card — one NCCL rank, or two gloo ranks sharing the card — equal the
    same ranks on the CPU (the plain versions) to 1e-10."""
    import torch_spmd_cases as cases
    from dolfinx_mpc_tpu_torch.parallel import run_ranks

    card = run_ranks(cases.card_rank, n_ranks, backend=backend, device="cuda")
    plain = run_ranks(cases.card_rank, n_ranks, backend="gloo", device="cpu")
    for got, ref in zip(card, plain):
        for case in ("lattice", "vector", "general"):
            assert np.abs(got[case]["u"] - ref[case]["u"]).max() <= 1e-10 * max(np.abs(ref[case]["u"]).max(), 1.0)
            assert abs(got[case]["its"] - ref[case]["its"]) <= 1
        assert min(got["launches"][k] for k in ("K2", "K7", "K8")) > 0, got["launches"]
        assert max(ref["launches"].values()) == 0


# ---------------------------------------------------------------------------
# The GMG V-cycle as a CUDA graph (la/gmg.py: LatticeGMG.__call__ through
# la/cycle_graph.py)
# ---------------------------------------------------------------------------

_GRAPH_CASES = {
    # name: (problem, levels or (n, n_levels), LatticeGMG keywords)
    "P1 chebyshev coarse": (_problem, (16, 3), dict(smoother="chebyshev", dense_max=0)),
    "P1 dense coarse, jacobi": (_problem, (16, 3), dict(smoother="jacobi")),
    "P1 cg coarse": (_problem, (16, 3), dict(smoother="chebyshev", coarse="cg", coarse_iters=12)),
    "P2 blocked_io": (_problem, [(2, 6), (1, 12), (1, 6)], dict(smoother="chebyshev", blocked_io=True)),
    "bs=3 chebyshev": (_elasticity_problem, (8, 2), dict(smoother="chebyshev", n_pre=3, n_post=3)),
}


def _graph_hierarchy(case, device):
    """The case's levels on the card in float32 and its LatticeGMG."""
    make, levels, kw = _GRAPH_CASES[case]
    if isinstance(levels, list):
        ops, masks = pt.build_gmg_hierarchy(
            lambda lv: make((lv[1],) * 3, np.float32, device, degree=lv[0])[5], levels[0][1], 0, levels=levels)
    else:
        n, n_levels = levels
        ops, masks = pt.build_gmg_hierarchy(lambda m: make((m,) * 3, np.float32, device)[5], n, n_levels, min_n=2)
    return ops, pt.LatticeGMG(ops, free_masks=masks, **kw)


def _graph_input(M, ops, seed):
    r = torch.as_tensor(np.random.default_rng(seed).standard_normal(ops[0].shape[0]), dtype=torch.float32,
                        device=ops[0].device)
    return ops[0].to_blocked(r) if M.blocked_io else r


def _graph_counts():
    """The span calls and the SpMV launch counters, one flat dict."""
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    out = {k: v[0] for k, v in tt.trace_timings().items()}
    for w in (LK.dia_matvec, LK.dia_matvec_bs, LK.blocked_matvec):
        out[w.__name__] = w.launches
        out.update({(w.__name__, k): v for k, v in w.launches_by_dtype.items()})
    out.update({("by_grid", k): v for k, v in LK.dia_matvec_bs.launches_by_grid.items()})
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.parametrize("case", list(_GRAPH_CASES))
def test_vcycle_graph_replay_equals_the_eager_cycle_on_card(cuda, case):
    """Every coarse mode, both smoothers, blocked I/O and K7: the replayed
    graph is torch.equal to the eager _vcycle for three inputs; a returned
    tensor is unchanged by the next call; one capture per input layout;
    after k replays the span calls and launch counters have grown by k
    times one eager cycle's, and gmg.vcycle and gmg.graph_replay by k."""
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    ops, M = _graph_hierarchy(case, cuda)
    rs = [_graph_input(M, ops, seed) for seed in range(3)]
    captures = tt.trace_timings().get("gmg.graph_capture", (0,))[0]
    ys = [M(r) for r in rs]
    kept = [y.clone() for y in ys]
    for r, y, y0 in zip(rs, ys, kept):
        assert torch.equal(y, y0)  # later calls left it alone
        assert torch.equal(y, M._vcycle(0, r))
    t0 = _graph_counts()
    M._vcycle(0, rs[0])
    torch.cuda.synchronize()
    eager = _delta(t0, _graph_counts())
    assert eager.get("dia_matvec", 0) + eager.get("dia_matvec_bs", 0) > 0
    k = 4
    t0 = _graph_counts()
    for _ in range(k):
        M(rs[1])
    torch.cuda.synchronize()
    got = _delta(t0, _graph_counts())
    assert got.pop("gmg.vcycle") == k and got.pop("gmg.graph_replay") == k
    assert got == {name: k * n for name, n in eager.items()}
    # a strided input of the same shape is the same layout
    assert torch.equal(M(torch.stack([rs[2], rs[2]], -1)[..., 0]), kept[2])
    assert tt.trace_timings()["gmg.graph_capture"][0] == captures + 1 and len(M._graphs) == 1


@pytest.mark.parametrize("case", ["P1 chebyshev coarse", "P2 blocked_io"])
def test_cg_under_the_vcycle_graph_on_card(cuda, case):
    """CG takes the same iterations and the same solution, bit for bit,
    under the replayed graph and under the eager cycle; one capture for
    the whole solve."""
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    ops, M = _graph_hierarchy(case, cuda)
    A = ops[0]
    mv = A.matvec_blocked if M.blocked_io else A.matvec
    b = _graph_input(M, ops, 7)
    captures = tt.trace_timings().get("gmg.graph_capture", (0,))[0]
    x_g, its_g, _ = pt.cg(mv, b, M=M, rtol=1e-6, max_it=500)
    x_e, its_e, _ = pt.cg(mv, b, M=lambda r: M._vcycle(0, r), rtol=1e-6, max_it=500)
    assert 0 < its_g < 500 and its_g == its_e and torch.equal(x_g, x_e)
    assert tt.trace_timings()["gmg.graph_capture"][0] == captures + 1


def test_vcycle_graph_of_a_tail_on_card(cuda):
    """The sharded path's replicated tail (parallel/lattice_spmd.py) is
    tail(1) of the coarse hierarchy: it captures on its first CUDA call,
    into its own graph table, and replays what the eager cycle gives."""
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    ops, cg = _graph_hierarchy("P1 chebyshev coarse", cuda)
    sub = cg.tail(1)
    captures = tt.trace_timings().get("gmg.graph_capture", (0,))[0]
    r = _graph_input(sub, sub.ops, 3)
    y1, y2 = sub(r), sub(r)
    assert torch.equal(y1, y2) and torch.equal(y1, sub._vcycle(0, r))
    assert tt.trace_timings()["gmg.graph_capture"][0] == captures + 1 and len(sub._graphs) == 1
    assert not cg._graphs


# ---------------------------------------------------------------------------
# The AMG V-cycle as a CUDA graph (la/amg.py: AMG.__call__ through
# la/cycle_graph.py)
# ---------------------------------------------------------------------------

# the relative max difference between two eager cycles, from the float
# atomics of index_add_ (the ELL remainder, the CSR levels): a replay runs
# the same kernels and is held to the same spread
_AMG_GRAPH_TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _amg_graph_case(dtype, device, bell_fine=False):
    """The tied contact at NB=12/NT=10 (10,584 dofs) and its AMG on the card
    with coarse_size 100: a block-ELL fine level (with bell_fine the BELL
    operator as fine_op, so the cycle launches K8), CSR levels below
    ell_min and a dense coarse inverse.  Returns (AMG, BELL operator, b)."""
    from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
    from dolfinx_mpc_tpu_torch.la.bell import BellMatrix, bell_from_scipy
    from dolfinx_mpc_tpu_torch.la.ell import BlockEllMatrix
    from dolfinx_mpc_tpu_torch.la.sparse import CSRMatrix
    from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

    V, bcs, mpc, a, L = _contact_problem(12, 10, np.float64, device)
    As = pt.assemble_matrix(a, mpc, bcs).to_scipy()
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
    B = bell_from_scipy(As, dtype=dtype, device=device)
    M = smoothed_aggregation_amg(As, bs=3, dtype=dtype, nullspace=rigid_motions_nullspace(V), coarse_size=100,
                                 fine_op=B if bell_fine else None, device=device)
    assert As.shape[0] == 10584 and isinstance(M.ops[0], BellMatrix if bell_fine else BlockEllMatrix)
    assert len(M.ops) >= 2 and all(isinstance(op, CSRMatrix) for op in M.ops[1:])
    assert M.coarse_inv is not None
    return M, B, b.to(getattr(torch, np.dtype(dtype).name))


def _rel_max(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _amg_graph_counts():
    """The span calls and K8's launch counters, one flat dict."""
    from dolfinx_mpc_tpu_torch.la.bell import bell_matvec
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    out = {k: v[0] for k, v in tt.trace_timings().items()}
    out["bell_matvec"] = bell_matvec.launches
    out.update({("bell_matvec", k): v for k, v in bell_matvec.launches_by_dtype.items()})
    return out


@pytest.mark.parametrize("fine", ["ell", "bell"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_amg_graph_replay_matches_the_eager_cycle_on_card(cuda, dtype, fine):
    """The replayed AMG cycle matches the eager _vcycle for three inputs to
    the eager cycle's own repeat spread (asserted beside it); a returned
    tensor is unchanged by the next call; one capture for every call;
    after k replays amg.vcycle and amg.graph_replay have grown by k and K8's
    counts by k times one eager cycle's (none on an ELL fine level)."""
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    M, _, b = _amg_graph_case(dtype, cuda, bell_fine=fine == "bell")
    tol = _AMG_GRAPH_TOL[dtype]
    rs = [torch.as_tensor(np.random.default_rng(seed).standard_normal(b.shape[0]), dtype=b.dtype, device=cuda)
          for seed in range(3)]
    captures = tt.trace_timings().get("amg.graph_capture", (0,))[0]
    ys = [M(r) for r in rs]
    kept = [y.clone() for y in ys]
    for r, y, y0 in zip(rs, ys, kept):
        assert torch.equal(y, y0)  # later calls left it alone
        eager = M._vcycle(0, r)
        assert _rel_max(M._vcycle(0, r), eager) <= tol and _rel_max(y, eager) <= tol
    t0 = _amg_graph_counts()
    M._vcycle(0, rs[0])
    torch.cuda.synchronize()
    eager = _delta(t0, _amg_graph_counts())
    assert (eager.get("bell_matvec", 0) > 0) == (fine == "bell")
    k = 4
    t0 = _amg_graph_counts()
    for _ in range(k):
        M(rs[1])
    torch.cuda.synchronize()
    got = _delta(t0, _amg_graph_counts())
    assert got.pop("amg.vcycle") == k and got.pop("amg.graph_replay") == k
    assert got == {name: k * n for name, n in eager.items()}
    assert tt.trace_timings()["amg.graph_capture"][0] == captures + 1 and len(M._graphs) == 1


def test_cg_under_the_amg_graph_on_card(cuda):
    """In float64 CG on the BELL operator takes as many iterations under
    the replayed AMG cycle as under the eager one, and the solutions agree
    to 1e-8; one capture for the whole solve."""
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    M, B, b = _amg_graph_case(np.float64, cuda)
    captures = tt.trace_timings().get("amg.graph_capture", (0,))[0]
    x_g, its_g, _ = pt.cg(B.matvec, b, M=M, rtol=1e-10, atol=0.0, max_it=500)
    x_e, its_e, _ = pt.cg(B.matvec, b, M=lambda r: M._vcycle(0, r), rtol=1e-10, atol=0.0, max_it=500)
    assert 0 < its_g < 500 and its_g == its_e and _rel_max(x_g, x_e) <= 1e-8
    assert tt.trace_timings()["amg.graph_capture"][0] == captures + 1 and len(M._graphs) == 1
