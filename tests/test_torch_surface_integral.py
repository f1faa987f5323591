"""Parity of the port's exterior-facet integrals with the JAX package: the
facet element kernels (ops/kernels.py), and matrices, vectors and lifting
assembled with facet terms under a constraint (ops/assemble.py).

Inputs are built from a seed with numpy (coordinates, coefficient values)
or are the structured meshes of both packages.  Tolerances: element
tensors and assembled values 1e-12 relative in float64 and 5e-6 in float32
(another summation order).  The facet normal is the outward one in the
port; the JAX package multiplies it by sign(detJ), which turns it inward
on negatively oriented cells (half the tets of create_box, none of the
2-D generators' cells): forms that read c.n are compared directly on 2-D
meshes and, on tets, with the JAX package's element tensors times
sign(detJ) (ROADMAP queue 3).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.ops.kernels import compile_term as jx_compile
from dolfinx_mpc_tpu.utils import compare_mpc_lhs as jx_lhs, compare_mpc_rhs as jx_rhs
from dolfinx_mpc_tpu_torch._dtypes import torch_dtype
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.ops.kernels import compile_term as pt_compile
from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs, compare_mpc_rhs

PKGS = {"jx": (jx, jf, jm), "pt": (pt, pf, pm)}
CASES = [("triangle", 1), ("triangle", 2), ("quadrilateral", 1), ("quadrilateral", 2),
         ("tetrahedron", 1), ("tetrahedron", 2)]
DTYPES = [(np.float64, 1e-12), (np.float32, 5e-6)]


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-300)


def _mesh(M, cell):
    return M.create_unit_cube(2, 2, 2) if cell == "tetrahedron" else M.create_unit_square(4, 4, cell)


@functools.lru_cache(maxsize=None)
def _setup(pkg, cell, degree, dtype=np.float64):
    """(V, mpc, bc, a, L): stiffness plus a facet term with a coefficient g
    (values from a seed) on the x=1 boundary, a facet source there; c.n
    enters on 2-D meshes only.  The general constraint ties the dof at
    x=1 (centre of the face) to the one at x=0, Dirichlet at y=0 (z=0)."""
    mod, F, M = PKGS[pkg]
    mesh = _mesh(M, cell)
    V = mod.functionspace(mesh, ("Lagrange", degree))
    g = mod.Function(V, name="g", **_kw(pkg))
    gv = np.random.default_rng(7).uniform(0.5, 1.5, V.num_dofs)
    if pkg == "pt":
        g.x.array.copy_(torch.as_tensor(gv))
    else:
        g.x.array[:] = gv
    tdim = mesh.tdim
    facets = M.locate_entities_boundary(mesh, tdim - 1, lambda x: np.isclose(x[0], 1.0))
    with_n = tdim == 2

    def robin(u, v, c):
        t = c["g"].value * F.inner(u, v)
        return t + F.dot(c.n, F.grad(u)) * F.conj(v.value) if with_n else t

    def source(v, c):
        s = (2.0 + c.x[1]) * v.value
        return s + c.n[0] * c["g"].value * v.value if with_n else s

    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v))) + mod.BilinearForm(
        V, robin, integral="exterior_facet", entities=facets, coefficients={"g": g})
    L = mod.LinearForm(V, source, integral="exterior_facet", entities=facets, coefficients={"g": g})
    mid = [0.5] * (tdim - 1)
    mpc = mod.MultiPointConstraint(V, dtype, **_kw(pkg))
    mpc.create_general_constraint({np.array([1.0] + mid).tobytes(): {np.array([0.0] + mid).tobytes(): 0.7}})
    mpc.finalize()
    bc = mod.dirichletbc(0.25, mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[tdim - 1], 0.0)), V)
    return V, mpc, bc, a, L


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("cell,degree", CASES)
def test_facet_element_tensors_match_jax(cell, degree, dtype, tol):
    """The facet kernels of both packages on the same coordinates (the
    mesh's, jittered by a seed), local facets and coefficient values."""
    Vj, _, _, aj, Lj = _setup("jx", cell, degree)
    Vp, _, _, ap, Lp = _setup("pt", cell, degree)
    rng = np.random.default_rng(3)
    for form_j, form_p, Vs in ((aj, ap, (Vj, Vp)), (Lj, Lp, (None, None))):
        ctj = jx_compile(form_j.terms[1 if form_j.rank == 2 else 0], Vj, Vs[0])
        ctp = pt_compile(form_p.terms[1 if form_p.rank == 2 else 0], Vp, Vs[1])
        assert np.array_equal(ctp.entities, ctj.entities) and np.array_equal(ctp.cells, ctj.cells)
        assert np.array_equal(ctp.local_facets, ctj.local_facets)
        coords = Vp.mesh.points[Vp.mesh.cells[ctp.cells]]
        coords = coords + 0.01 * rng.standard_normal(coords.shape)
        w = rng.uniform(0.5, 1.5, (len(ctp.cells), Vp.dofmap.shape[1]))
        ref = np.asarray(ctj.kernel(jnp.asarray(coords, dtype), jnp.asarray(ctj.local_facets),
                                    {"g": jnp.asarray(w, dtype)}))
        got = ctp.kernel(torch.as_tensor(coords, dtype=torch.float64).to(torch_dtype(dtype)),
                         torch.as_tensor(ctp.local_facets), {"g": torch.as_tensor(w).to(
                             torch_dtype(dtype))})
        assert got.dtype == torch_dtype(dtype)
        assert _rel(got.numpy(), ref) <= tol


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("cell,degree", CASES)
def test_facet_assembly_matches_jax(cell, degree, dtype, tol):
    """Constrained matrix, vector and lifting of forms with a cell and a
    facet term (the lifting's facets filtered in step with their cells)."""
    Vj, mj, bcj, aj, Lj = _setup("jx", cell, degree, dtype)
    Vp, mp, bcp, ap, Lp = _setup("pt", cell, degree, dtype)
    Aj = jx.assemble_matrix(aj, mj, bcs=[bcj], dtype=dtype).to_scipy()
    Ap = pt.assemble_matrix(ap, mp, bcs=[bcp], dtype=dtype).to_scipy()
    assert np.array_equal(Ap.indptr, Aj.indptr) and np.array_equal(Ap.indices, Aj.indices)
    assert abs(Ap - Aj).max() <= tol * abs(Aj).max()
    bj = jx.set_bc(jx.apply_lifting(jx.assemble_vector(Lj, mj, dtype=dtype), [aj], [[bcj]], mj, dtype=dtype), [bcj])
    bp = pt.set_bc(pt.apply_lifting(pt.assemble_vector(Lp, mp, dtype=dtype), [ap], [[bcp]], mp, dtype=dtype), [bcp])
    assert bp.dtype == torch_dtype(dtype)
    assert _rel(bp.numpy(), bj) <= tol
    # the lifting alone, whose tables hold only the facets touching bc dofs
    lj = jx.apply_lifting(np.zeros(Vj.num_dofs, dtype), [aj], [[bcj]], mj, dtype=dtype)
    lp = pt.apply_lifting(torch.zeros(Vp.num_dofs, dtype=bp.dtype), [ap], [[bcp]], mp, dtype=dtype)
    assert np.abs(np.asarray(lj)).max() > 0
    assert _rel(lp.numpy(), lj) <= tol


@pytest.mark.parametrize("degree", [1, 2])
def test_tet_facet_normal_is_outward(degree):
    """On tets the port's c.n is the outward normal: its element vectors of
    inner(c.n, v) are the JAX package's times sign(detJ) of each facet's
    cell, and c.n matches the geometric outward normal of every boundary
    facet."""
    mesh_p = pm.create_unit_cube(2, 2, 2)
    Vp = pt.functionspace(mesh_p, ("Lagrange", degree, (3,)))
    Vj = jx.functionspace(jm.create_unit_cube(2, 2, 2), ("Lagrange", degree, (3,)))
    Lp = pt.LinearForm(Vp, lambda v, c: pf.inner(c.n, v), integral="exterior_facet")
    Lj = jx.LinearForm(Vj, lambda v, c: jf.inner(c.n, v), integral="exterior_facet")
    ctp, ctj = pt_compile(Lp.terms[0], Vp, None), jx_compile(Lj.terms[0], Vj, None)
    coords = mesh_p.points[mesh_p.cells[ctp.cells]]
    got = ctp.kernel(torch.as_tensor(coords), torch.as_tensor(ctp.local_facets), {}).numpy()
    ref = np.asarray(ctj.kernel(jnp.asarray(coords), jnp.asarray(ctj.local_facets), {}))
    e = coords[:, 1:] - coords[:, :1]
    sign = np.sign(np.linalg.det(e.transpose(0, 2, 1)))
    assert (sign < 0).any() and (sign > 0).any()
    assert _rel(got, ref * sign[:, None]) <= 1e-12
    # the normal itself: n = sum over the facet's basis of the element vector
    # of inner(n, v) / facet area, at degree 1 (each facet is flat)
    if degree == 1:
        from dolfinx_mpc_tpu_torch.utils.mpc_utils import _facet_outward_normals

        n_geo = _facet_outward_normals(mesh_p, ctp.entities)
        area = pt_compile(pt.LinearForm(pt.functionspace(mesh_p, ("Lagrange", 1)), lambda v, c: v.value,
                                        integral="exterior_facet").terms[0], pt.functionspace(
            mesh_p, ("Lagrange", 1)), None).kernel(torch.as_tensor(coords), torch.as_tensor(ctp.local_facets),
                                                   {}).numpy().sum(axis=1)
        n_int = got.reshape(len(got), -1, 3).sum(axis=1) / area[:, None]
        assert np.abs(n_int - n_geo).max() <= 1e-12


# ---- the three cases of tests/test_surface_integral.py --------------------


def _rhs_case(pkg, dtype):
    mod, F, M = PKGS[pkg]
    mesh = M.create_unit_square(4, 4)
    V = mod.functionspace(mesh, ("Lagrange", 1))
    facets = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 1.0))
    mpc = mod.MultiPointConstraint(V, dtype=dtype, **_kw(pkg))
    mpc.create_general_constraint({np.array([1.0, 0.5]).tobytes(): {np.array([0.0, 0.5]).tobytes(): 0.8}})
    mpc.finalize()
    L = mod.LinearForm(V, lambda v, c: (2.0 + c.x[1]) * v.value, integral="exterior_facet", entities=facets)
    return mpc, (mod.assemble_vector(L, None, dtype=dtype, **_kw(pkg)), mod.assemble_vector(L, mpc, dtype=dtype))


def _bilinear_case(pkg, dtype):
    mod, F, M = PKGS[pkg]
    mesh = M.create_unit_square(4, 4)
    V = mod.functionspace(mesh, ("Lagrange", 2))
    facets = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[1], 1.0))
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v))) + mod.BilinearForm(
        V, lambda u, v, c: 3.0 * F.inner(u, v), integral="exterior_facet", entities=facets)
    mpc = mod.MultiPointConstraint(V, dtype=dtype, **_kw(pkg))
    mpc.create_general_constraint({np.array([0.5, 1.0]).tobytes(): {np.array([0.5, 0.0]).tobytes(): 0.4}})
    mpc.finalize()
    return mpc, (mod.assemble_matrix(a, None, dtype=dtype, **_kw(pkg)).to_scipy(),
                 mod.assemble_matrix(a, mpc, dtype=dtype).to_scipy())


def _coefficient_case(pkg, dtype):
    mod, F, M = PKGS[pkg]
    mesh = M.create_unit_square(3, 3)
    V = mod.functionspace(mesh, ("Lagrange", 1))
    g = mod.Function(V, name="g", **_kw(pkg))
    g.interpolate(lambda x: x[0] ** 2 + x[1])
    facets = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 0.0))
    L = mod.LinearForm(V, lambda v, c: c["g"].value * v.value, integral="exterior_facet", entities=facets,
                       coefficients={"g": g})
    mpc = mod.MultiPointConstraint(V, dtype=dtype, **_kw(pkg))
    mpc.create_general_constraint({np.array([0.0, 1.0]).tobytes(): {np.array([1.0, 1.0]).tobytes(): 0.3}})
    mpc.finalize()
    return mpc, (mod.assemble_vector(L, None, dtype=dtype, **_kw(pkg)), mod.assemble_vector(L, mpc, dtype=dtype))


@pytest.mark.parametrize("case,compare", [(_rhs_case, "rhs"), (_bilinear_case, "lhs"), (_coefficient_case, "rhs")],
                         ids=["surface_rhs_with_mpc", "surface_bilinear_with_mpc", "surface_with_coefficient"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128], ids=["real", "complex"])
def test_surface_integral_cases(case, compare, dtype):
    """tests/test_surface_integral.py's three cases through the port: the
    K^H A K / K^H b oracle holds, and the assembled values equal the JAX
    package's to 1e-12 relative."""
    mj, (org_j, mpc_j) = case("jx", dtype)
    mp, (org_p, mpc_p) = case("pt", dtype)
    if compare == "lhs":
        compare_mpc_lhs(org_p, mpc_p, mp)
        jx_lhs(org_j, mpc_j, mj)
        assert abs(mpc_p - mpc_j).max() <= 1e-12 * abs(mpc_j).max()
    else:
        compare_mpc_rhs(org_p, mpc_p, mp)
        jx_rhs(np.asarray(org_j), np.asarray(mpc_j), mj)
        assert _rel(mpc_p.numpy(), mpc_j) <= 1e-12


def test_mixed_spaces_still_raise():
    """Facet terms compile on a uniform space and, since mixed spaces were
    ported (the test keeps the name it had while they raised), on a mixed
    Taylor-Hood space: its exterior-facet vector (the normal flux on the
    velocity field, y times the pressure test function) equals the JAX
    package's to 1e-12 relative on a 2-D mesh."""
    V = pt.functionspace(pm.create_unit_square(2, 2), ("Lagrange", 1))
    term = pt.LinearForm(V, lambda v, c: v.value, integral="exterior_facet").terms[0]
    assert pt_compile(term, V, None).local_facets is not None
    out = []
    for pkg in ("jx", "pt"):
        mod, F, M = PKGS[pkg]
        mesh = M.create_unit_square(3, 3)
        W = mod.mixed_functionspace(mesh, [("Lagrange", 2, (2,)), ("Lagrange", 1)])
        facets = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[0], 1.0) | np.isclose(x[1], 0.0))
        L = mod.LinearForm(W, lambda v, c: F.inner(c.n, v[0]) + c.x[1] * v[1].value, integral="exterior_facet",
                           entities=facets)
        out.append(np.asarray(mod.assemble_vector(L, None, **_kw(pkg))))
    assert out[1].shape == out[0].shape and np.abs(out[0]).max() > 0
    assert np.abs(out[1] - out[0]).max() <= 1e-12 * np.abs(out[0]).max()


def test_tr_outer_identity_forms_match_jax():
    """tr, outer and Identity in a cell term (a Hooke stress) and a facet
    term (outer products with the normal) of a 2-D vector form, assembled
    in float64: the JAX package's values to 1e-12 relative."""
    out = []
    for pkg in ("jx", "pt"):
        mod, F, M = PKGS[pkg]
        mesh = M.create_unit_square(3, 3)
        V = mod.functionspace(mesh, ("Lagrange", 2, (2,)))

        def hooke(u, v, c):
            eps = F.sym(F.grad(u))
            return F.inner(2.0 * eps + 1.25 * F.tr(eps) * F.Identity(2), F.sym(F.grad(v)))

        facets = M.locate_entities_boundary(mesh, 1, lambda x: np.isclose(x[1], 0.0))
        a = mod.BilinearForm(V, hooke) + mod.BilinearForm(
            V, lambda u, v, c: F.inner(F.outer(u.value, c.n), F.outer(v.value, c.n)) + F.tr(F.Identity(2)) * F.inner(
                u, v), integral="exterior_facet", entities=facets)
        out.append(mod.assemble_matrix(a, None, **_kw(pkg)).to_scipy())
    assert np.array_equal(out[1].indices, out[0].indices)
    assert abs(out[1] - out[0]).max() <= 1e-12 * abs(out[0]).max()
