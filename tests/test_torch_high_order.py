"""Lagrange elements of degree 4-6 in the port against the JAX package
(tests/test_high_order.py): the tabulated bases and gradients equal the
JAX package's to 1e-12 on every cell, with the nodal delta property and the
partition of unity; exact reproduction of a degree-4 polynomial; the
degree-4 MPC matrix through the port's assembler equal to the K^H A K
oracle and to the JAX package's; the P4 Poisson problem with a quartic
exact solution."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem.elements import lagrange_element as jx_element
from dolfinx_mpc_tpu.fem.forms import grad as jgrad, inner as jinner
from dolfinx_mpc_tpu.fem.mesh import create_unit_cube as jx_cube
from dolfinx_mpc_tpu_torch.fem.cells import get_cell
from dolfinx_mpc_tpu_torch.fem.elements import lagrange_element
from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
from dolfinx_mpc_tpu_torch.fem.mesh import CellType, create_unit_cube, create_unit_square
from dolfinx_mpc_tpu_torch.fem.quadrature import quadrature_rule
from dolfinx_mpc_tpu_torch.utils import gather_transformation_matrix


def _points(cell, n, seed):
    """n random points inside the reference cell."""
    c = get_cell(cell)
    rng = np.random.default_rng(seed)
    pts = rng.random((n, c.tdim))
    if c.is_simplex:
        pts *= rng.random((n, 1)) / np.maximum(pts.sum(1, keepdims=True), 1e-9)
    return pts


@pytest.mark.parametrize("cell", ["interval", "triangle", "quadrilateral", "tetrahedron", "hexahedron"])
@pytest.mark.parametrize("degree", [4, 5, 6])
def test_element_nodal_basis(cell, degree):
    el, el_j = lagrange_element(cell, degree), jx_element(cell, degree)
    assert np.abs(el.nodes - el_j.nodes).max() < 1e-12
    tab = el.tabulate(el.nodes)
    assert np.abs(tab - np.eye(el.ndofs)).max() < 1e-9  # nodal delta
    pts = _points(cell, 100, 1)
    phi, dphi = el.tabulate(pts), el.tabulate_grad(pts)
    assert np.abs(phi.sum(axis=1) - 1.0).max() < 1e-9  # partition of unity
    assert np.abs(dphi.sum(axis=1)).max() < 1e-7
    assert np.abs(phi - el_j.tabulate(pts)).max() < 1e-12
    assert np.abs(dphi - el_j.tabulate_grad(pts)).max() < 1e-12 * max(1.0, np.abs(dphi).max())


@pytest.mark.parametrize("cell", ["triangle", "quadrilateral", "tetrahedron", "hexahedron"])
def test_element_reproduces_degree4_polynomial(cell):
    el = lagrange_element(cell, 4)
    tdim = get_cell(cell).tdim

    def p(x):
        out = 1.0 + x[:, 0] ** 4 - 2.3 * x[:, 0] ** 3 + 0.7 * x[:, 0]
        if tdim > 1:
            out = out + x[:, 1] ** 4 + 1.1 * x[:, 0] ** 2 * x[:, 1] ** 2
        if tdim > 2:
            out = out + 0.4 * x[:, 2] ** 4 - x[:, 0] * x[:, 1] * x[:, 2]
        return out

    pts = _points(cell, 200, 2)
    assert np.abs(el.tabulate(pts) @ p(el.nodes) - p(pts)).max() < 1e-9


@pytest.mark.parametrize("cell_type", [CellType.tetrahedron, CellType.hexahedron])
def test_degree4_mpc_oracle(cell_type):
    """P4/Q4 periodic Poisson through the port's general assembler: the
    constrained matrix equals K^H A K and the JAX package's."""
    mats = {}
    for name, pkg, cube, g, i in (("pt", pt, create_unit_cube, grad, inner), ("jx", jx, jx_cube, jgrad, jinner)):
        V = pkg.functionspace(cube(2, 2, 2, cell_type=cell_type), ("Lagrange", 4))
        bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(
            V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
        mpc = pkg.MultiPointConstraint(V, np.float64, **({"device": "cpu"} if pkg is pt else {}))
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
        mpc.finalize()
        a = pkg.BilinearForm(V, lambda u, v, c, g=g, i=i: i(g(u), g(v)))
        kw = {"device": "cpu"} if pkg is pt else {}
        mats[name] = (pkg.assemble_matrix(a, None, bcs=[bc], **kw).to_scipy(),
                      pkg.assemble_matrix(a, mpc, bcs=[bc], **kw).to_scipy(), mpc, V)
    A_org, A_mpc, mpc, V = mats["pt"]
    K = gather_transformation_matrix(mpc)
    keep = np.setdiff1d(np.arange(V.num_dofs), np.asarray(mpc.slaves))
    diff = (K.T @ A_org @ K).tocsr() - A_mpc[keep][:, keep]
    assert (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-8
    assert abs(A_mpc - mats["jx"][1]).max() < 1e-12 * abs(A_mpc).max()


def test_degree4_poisson_exact_quartic():
    """-Laplace u = f with u a quartic lies in the P4 space: the port's
    discrete solution equals it to solver precision."""
    mesh = create_unit_square(3, 3)
    V = pt.functionspace(mesh, ("Lagrange", 4))

    def u_ex(x):
        return x[:, 0] ** 4 + x[:, 1] ** 4 - x[:, 0] ** 2 * x[:, 1] ** 2

    def f_fn(x):  # -laplace(u_ex)
        return -(12 * x[:, 0] ** 2 + 12 * x[:, 1] ** 2 - 2 * x[:, 1] ** 2 - 2 * x[:, 0] ** 2)

    bdofs = pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[0], 0) | np.isclose(x[0], 1)
                                       | np.isclose(x[1], 0) | np.isclose(x[1], 1))
    coords = V.dof_coords_blocks
    A = pt.assemble_matrix(pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v))), None,
                           device="cpu").to_scipy().tocsr()
    el = V.element
    qpts, qw = quadrature_rule(el.cell, 2 * el.degree)
    phi = el.tabulate(qpts)
    geo = lagrange_element(el.cell.name, 1)
    cellxyz = mesh.points[mesh.cells]
    xq = np.einsum("qv,cvg->cqg", geo.tabulate(qpts), cellxyz)
    detJ = np.abs(np.linalg.det(np.einsum("cvg,qvt->cqgt", cellxyz, geo.tabulate_grad(qpts))))
    fq = f_fn(xq.reshape(-1, 2)).reshape(xq.shape[0], -1)
    b = np.zeros(V.num_dofs)
    np.add.at(b, V.dofmap, np.einsum("q,cq,qd->cd", qw, fq * detJ, phi))
    free = np.setdiff1d(np.arange(V.num_dofs), bdofs)
    x = np.zeros(V.num_dofs)
    x[bdofs] = u_ex(coords[bdofs])
    rhs = b - A @ x
    x[free] = spla.spsolve(A[free][:, free].tocsr(), rhs[free])
    assert np.abs(x - u_ex(coords)).max() < 1e-8
