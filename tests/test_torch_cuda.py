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
