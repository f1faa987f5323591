"""The lattice path's side formats and element-kernel paths against the JAX
package on the CPU (float64): the port's counterparts of
tests/test_lattice.py (every cell type on the default "csr" format, the
vector space, "cells" and "fold" with the non-foldable constraint) and
tests/test_lattice_p2.py, coefficient and x-dependent forms and a
perturbed lattice geometry on each format, the refusal of "cells" where
the JAX package refuses it, and LinearProblem's fold -> cells -> general
choice."""

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as JF
from dolfinx_mpc_tpu.fem import mesh as JM
from dolfinx_mpc_tpu.ops.lattice import LatticeOperator as JLatticeOperator
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu.ops.soa_kernels import compile_cell_kernel_soa
from dolfinx_mpc_tpu_torch.fem import forms as PF
from dolfinx_mpc_tpu_torch.fem import mesh as PM
from dolfinx_mpc_tpu_torch.ops.lattice import BlockDIAMatrix, LatticeOperator, soa_supported

PKGS = {"jx": (jx, JF, JM), "pt": (pt, PF, PM)}
MESHERS = {
    "triangle": lambda M: M.create_unit_square(4, 3),
    "quadrilateral": lambda M: M.create_unit_square(3, 4, "quadrilateral"),
    "tetrahedron": lambda M: M.create_unit_cube(3, 2, 2),
    "hexahedron": lambda M: M.create_unit_cube(2, 3, 2, "hexahedron"),
}


def _mpc(pkg, V, dtype=np.float64):
    return pkg.MultiPointConstraint(V, dtype, **({"device": "cpu"} if pkg is pt else {}))


def _periodic(pkg, V, bcs):
    mpc = _mpc(pkg, V)
    rel = ((lambda x: np.stack([1.0 - x[0], x[1]])) if V.mesh.gdim == 2
           else (lambda x: np.stack([1.0 - x[0], x[1], x[2]])))
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0), rel, bcs)
    mpc.finalize()
    return mpc


def _lattice(pkg, a, mpc, bcs, **kw):
    if pkg is pt:
        return pt.assemble_matrix_lattice(a, mpc, bcs=bcs, device="cpu", **kw)
    return jx_lattice(a, mpc, bcs=bcs, **kw)


def _matvec(A, x):
    if isinstance(A, LatticeOperator):
        return A.matvec(torch.as_tensor(x)).numpy()
    import jax.numpy as jnp

    return np.asarray(A.matvec(jnp.asarray(x)))


def _diag(A):
    d = A.diagonal()
    return d.numpy() if isinstance(d, torch.Tensor) else np.asarray(d)


def _max(S):
    S = S.tocoo()
    return float(np.abs(S.data).max()) if S.nnz else 0.0


def _agree(Ap, ref, tol_s, tol_mv, tol_d, seed=1):
    """Ap (a port LatticeOperator) equals `ref` (a JAX LatticeOperator or
    a scipy matrix): to_scipy, matvec on a seeded vector, diagonal."""
    S = ref if not hasattr(ref, "matvec") else ref.to_scipy()
    assert _max(Ap.to_scipy() - S) < tol_s
    x = np.random.default_rng(seed).standard_normal(S.shape[0])
    assert np.abs(Ap.matvec(torch.as_tensor(x)).numpy() - S @ x).max() < tol_mv
    if hasattr(ref, "matvec"):
        assert np.abs(Ap.matvec(torch.as_tensor(x)).numpy() - _matvec(ref, x)).max() < tol_mv
    assert np.abs(_diag(Ap) - S.diagonal()).max() < tol_d


@pytest.mark.parametrize("cell_type", list(MESHERS))
def test_lattice_matches_general(cell_type):
    """tests/test_lattice.py::test_lattice_matches_general: the port's
    lattice operator on its default side format ("csr") equals the JAX
    package's general assembler and its lattice operator."""
    ops = {}
    for name, (pkg, F, M) in PKGS.items():
        mesh = MESHERS[cell_type](M)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
        mpc = _periodic(pkg, V, [bc])
        a = pkg.BilinearForm(V, lambda u, v, c, F=F: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))
        ops[name] = (_lattice(pkg, a, mpc, [bc], diagval=2.0), pkg, a, mpc, bc)
    clf, _, _, _, _ = ops["pt"]
    assert clf.side_format == "csr"
    Ap = clf.assemble()
    clf_j, _, aj, mpcj, bcj = ops["jx"]
    A_ref = jx.assemble_matrix(aj, mpcj, bcs=[bcj], diagval=2.0).to_scipy()
    _agree(Ap, A_ref, 1e-12, 1e-11, 1e-12)
    _agree(Ap, clf_j.assemble(), 1e-12, 1e-11, 1e-12)


def test_lattice_vector_space():
    """tests/test_lattice.py::test_lattice_vector_space: a 2-D vector space
    with a general (not plane-wrap) constraint on the default format."""
    ops = {}
    for name, (pkg, F, M) in PKGS.items():
        V = pkg.functionspace(M.create_unit_square(3, 3), ("Lagrange", 1, (2,)))
        mpc = _mpc(pkg, V)
        mpc.create_general_constraint(
            {np.array([1.0, 1.0]).tobytes(): {np.array([0.0, 0.0]).tobytes(): 0.5}})
        mpc.finalize()
        a = pkg.BilinearForm(V, lambda u, v, c, F=F: 2.0 * F.inner(F.sym(F.grad(u)), F.sym(F.grad(v)))
                             + 1.25 * F.div(u) * F.conj(F.div(v)))
        ops[name] = (pkg, a, mpc)
    pkg, aj, mpcj = ops["jx"]
    _, ap, mpcp = ops["pt"]
    Ap = pt.assemble_matrix_lattice(ap, mpcp, device="cpu").assemble()
    assert Ap.dia.bs == 2 and Ap.side_data.shape[0] > 0
    _agree(Ap, jx.assemble_matrix(aj, mpcj).to_scipy(), 1e-12, 1e-11, 1e-12)


def _cube_problem(pkg, F, M, dims, integrand, quad_degree):
    mesh = M.create_unit_cube(*dims)
    V = pkg.functionspace(mesh, ("Lagrange", 1))
    bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
    mpc = _periodic(pkg, V, [bc])
    return V, bc, mpc, pkg.BilinearForm(V, integrand(F), quad_degree=quad_degree)


def test_lattice_cells_side_format():
    """tests/test_lattice.py::test_lattice_cells_side_format: "cells" gives
    the "csr" operator, in the port and in the JAX package."""
    grad_grad = lambda F: (lambda u, v, c: F.inner(F.grad(u), F.grad(v)))  # noqa: E731
    Vj, bcj, mpcj, aj = _cube_problem(jx, JF, JM, (3, 3, 3), grad_grad, 1)
    Vp, bcp, mpcp, ap = _cube_problem(pt, PF, PM, (3, 3, 3), grad_grad, 1)
    A_csr = _lattice(pt, ap, mpcp, [bcp], diagval=2.0).assemble()
    A_cel = _lattice(pt, ap, mpcp, [bcp], diagval=2.0, side_format="cells").assemble()
    assert A_cel.side_Aep.shape[0] > 0 and A_cel.slaves.shape[0] == mpcp.num_local_slaves
    _agree(A_cel, A_csr.to_scipy(), 1e-12, 1e-12, 1e-12, seed=5)
    x = np.random.default_rng(5).standard_normal(Vp.num_dofs)
    assert np.abs(A_cel.matvec(torch.as_tensor(x)).numpy() - A_csr.matvec(torch.as_tensor(x)).numpy()).max() < 1e-12
    _agree(A_cel, _lattice(jx, aj, mpcj, [bcj], diagval=2.0, side_format="cells").assemble(), 1e-12, 1e-12, 1e-12)


def test_lattice_fold_format():
    """tests/test_lattice.py::test_lattice_fold_format: "fold" equals "csr"
    for a plane wrap, and a constraint that is not one raises ValueError in
    both packages."""
    react = lambda F: (lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))  # noqa: E731
    Vj, bcj, mpcj, aj = _cube_problem(jx, JF, JM, (4, 3, 3), react, 2)
    Vp, bcp, mpcp, ap = _cube_problem(pt, PF, PM, (4, 3, 3), react, 2)
    A_csr = _lattice(pt, ap, mpcp, [bcp], diagval=3.0).assemble()
    A_fold = _lattice(pt, ap, mpcp, [bcp], diagval=3.0, side_format="fold").assemble()
    assert A_fold.fold_axis == 0
    _agree(A_fold, A_csr.to_scipy(), 1e-11, 1e-11, 1e-11, seed=9)
    _agree(A_fold, _lattice(jx, aj, mpcj, [bcj], diagval=3.0, side_format="fold").assemble(), 1e-12, 1e-11,
           1e-12, seed=9)
    for pkg, V, a, bc in ((jx, Vj, aj, bcj), (pt, Vp, ap, bcp)):
        mpc2 = _mpc(pkg, V)
        mpc2.create_general_constraint(
            {np.array([1.0, 1.0, 1.0]).tobytes(): {np.array([0.0, 0.0, 0.0]).tobytes(): 0.5}})
        mpc2.finalize()
        with pytest.raises(ValueError):
            _lattice(pkg, a, mpc2, [bc], side_format="fold")


@pytest.mark.parametrize("cube", [False, True])
@pytest.mark.parametrize("fmt", ["fold", "csr", "cells"])
def test_p2_lattice_matches_general(cube, fmt):
    """tests/test_lattice_p2.py::test_p2_lattice_matches_general: degree 2
    on every format (fold: the parity-blocked layout, in 2-D through the
    element-kernel lean path) equals the JAX general assembler."""
    ops = {}
    for name, (pkg, F, M) in PKGS.items():
        mesh = M.create_unit_cube(3, 3, 3) if cube else M.create_unit_square(3, 3)
        V = pkg.functionspace(mesh, ("Lagrange", 2))
        bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(
            V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
        mpc = _periodic(pkg, V, [bc])
        ops[name] = (pkg.BilinearForm(V, lambda u, v, c, F=F: F.inner(F.grad(u), F.grad(v)), quad_degree=2), mpc, bc)
    aj, mpcj, bcj = ops["jx"]
    ap, mpcp, bcp = ops["pt"]
    A_ref = jx.assemble_matrix(aj, mpcj, bcs=[bcj]).to_scipy()
    clf = _lattice(pt, ap, mpcp, [bcp], side_format=fmt)
    A = clf.assemble()
    assert isinstance(A.dia, BlockDIAMatrix) == (fmt == "fold")
    assert _max(A.to_scipy() - A_ref) < 1e-10


ABS_CASES = {
    "fold": (1, "fold", "fold_pairs"),
    "csr": (1, "csr", "side_data"),
    "cells": (1, "cells", "side_Aep"),
    "P2 blocked fold": (2, "fold", "fold_mask_b"),
}


def _same_but_abs(A, B):
    """B carries every attribute of A: the value tensors as their torch.abs,
    a nested DIA recursively, diagval as its abs, every other field as the
    same object."""
    assert vars(B).keys() == vars(A).keys()
    for k, v in vars(A).items():
        w = getattr(B, k)
        if k == "dia":
            _same_but_abs(v, w)
        elif k == "diagval":
            assert w == abs(v)
        elif k in ("data", "side_data", "side_Aep") and v is not None:
            assert torch.equal(w, torch.abs(v))
        else:
            assert w is v, k


@pytest.mark.parametrize("case", list(ABS_CASES))
def test_lattice_operator_abs_carries_every_field(case):
    """LatticeOperator.abs() (the Gershgorin bound's |A|) on each side
    format and on the degree-2 blocked fold: every field of the operator
    and of its DIA carried, the value tensors made absolute; a field added
    later fails here until abs() carries it."""
    degree, fmt, field = ABS_CASES[case]
    V = pt.functionspace(PM.create_unit_cube(3, 3, 3), ("Lagrange", degree))
    bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = _periodic(pt, V, [bc])
    a = pt.BilinearForm(V, lambda u, v, c: PF.inner(PF.grad(u), PF.grad(v)), quad_degree=degree)
    A = _lattice(pt, a, mpc, [bc], diagval=-2.0, side_format=fmt).assemble()
    assert getattr(A, field) is not None and isinstance(A.dia, BlockDIAMatrix) == (degree == 2)
    B = A.abs()
    assert B.diagval == 2.0 and bool((A.dia.data < 0).any())
    _same_but_abs(A, B)
    ones = torch.ones(A.shape[0], dtype=A.dtype)
    assert (B.matvec(ones).numpy() >= abs(A.to_scipy()) @ ones.numpy() - 1e-12).all()  # bounds |K^H A K| . 1


def _perturbed(M, dims):
    """A lattice box whose interior points are moved by a bump that
    vanishes on the boundary, so the lattice info and the periodic planes
    stay, and the geometry is no longer uniform."""
    mesh = M.create_unit_cube(*dims)
    x = mesh.points
    x[:, 1] += 0.04 * np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]) * np.sin(2 * np.pi * x[:, 2])
    return mesh


FORMS = {
    # inner(kappa grad u, grad v), kappa = 1 + x0 x1 in P1
    "coefficient": lambda pkg, F, V: pkg.BilinearForm(
        V, lambda u, v, c: c["kappa"].value * F.inner(F.grad(u), F.grad(v)),
        coefficients={"kappa": _kappa(pkg, V)}),
    "x-dependent": lambda pkg, F, V: pkg.BilinearForm(
        V, lambda u, v, c: (1.0 + c.x[0] * c.x[2]) * F.inner(F.grad(u), F.grad(v)) + F.inner(u, v)),
    "perturbed geometry": lambda pkg, F, V: pkg.BilinearForm(
        V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + 0.5 * F.inner(u, v)),
}


def _kappa(pkg, V):
    k = pkg.Function(V, **({"device": "cpu"} if pkg is pt else {}))
    k.interpolate(lambda x: 1.0 + x[0] * x[1])
    return k


@pytest.mark.parametrize("fmt", ["fold", "csr", "cells"])
@pytest.mark.parametrize("kind", list(FORMS))
def test_element_kernel_forms_match_jax(kind, fmt):
    """A coefficient form and an x-dependent form on the uniform lattice,
    and a constant form on a perturbed lattice geometry, on each format:
    the port's operator equals the JAX package's to 1e-12 (to_scipy,
    matvec, diagonal)."""
    ops = {}
    for name, (pkg, F, M) in PKGS.items():
        mesh = _perturbed(M, (4, 3, 3)) if kind == "perturbed geometry" else M.create_unit_cube(4, 3, 3)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
        mpc = _periodic(pkg, V, [bc])
        ops[name] = _lattice(pkg, FORMS[kind](pkg, F, V), mpc, [bc], diagval=1.5, side_format=fmt)
    route = {"fold": "lean" if kind == "x-dependent" else "cells"}.get(fmt, "cells")
    assert ops["pt"]._route == route
    _agree(ops["pt"].assemble(), ops["jx"].assemble(), 1e-12, 1e-12, 1e-12)


CELLS_CASES = {
    "tet P1": ("tetrahedron", 1, None, None),
    "tet P2": ("tetrahedron", 2, None, None),
    "tet P2 q2": ("tetrahedron", 2, None, 2),
    "tet P1 bs=3": ("tetrahedron", 1, 3, None),
    "hex Q1": ("hexahedron", 1, None, None),
    "tri P2 bs=2": ("triangle", 2, 2, None),
    "tri P2 bs=2 q2": ("triangle", 2, 2, 2),
    "quad Q1 bs=2": ("quadrilateral", 1, 2, None),
}


@pytest.mark.parametrize("case", list(CELLS_CASES))
def test_cells_format_refused_where_jax_refuses(case):
    """soa_supported holds exactly where the JAX package builds its
    SoA kernel, and "cells" assembles exactly there: elsewhere the port
    raises ValueError where the JAX package fails its assertion."""
    cell, degree, bs, qd = CELLS_CASES[case]
    refused = {}
    for name, (pkg, F, M) in PKGS.items():
        mesher = {"tetrahedron": lambda: M.create_unit_cube(2, 2, 2),
                  "hexahedron": lambda: M.create_unit_cube(2, 2, 2, "hexahedron"),
                  "triangle": lambda: M.create_unit_square(2, 2),
                  "quadrilateral": lambda: M.create_unit_square(2, 2, "quadrilateral")}[cell]
        V = pkg.functionspace(mesher(), ("Lagrange", degree, (bs,)) if bs else ("Lagrange", degree))
        a = pkg.BilinearForm(V, lambda u, v, c, F=F: F.inner(F.grad(u), F.grad(v)), quad_degree=qd)
        mpc = _periodic(pkg, V, [])
        if pkg is pt:
            supported = soa_supported(V.mesh, V, V, a.terms[0])
        else:
            expect = compile_cell_kernel_soa(V.mesh, V, V, a.terms[0], np.float64) is not None
        try:
            _lattice(pkg, a, mpc, [], side_format="cells")
            refused[name] = False
        except (AssertionError, ValueError) as e:
            assert isinstance(e, ValueError if pkg is pt else AssertionError)
            refused[name] = True
    assert supported == expect
    assert refused["pt"] == refused["jx"] == (not expect)


def _route(A):
    if isinstance(A, (LatticeOperator, JLatticeOperator)):
        return "fold" if A.fold_axis is not None else "cells"
    return "general"


LP_CASES = {
    # plane wrap, P1 tets: fold
    "fold 3-D": ("cube", 1, "wrap", None),
    # the 2-D periodic square (demo_periodic_geometrical): fold
    "fold 2-D": ("square", 1, "wrap", None),
    # a general constraint on a lattice mesh: cells
    "cells": ("cube", 1, "general", None),
    # P2 tets at the default quadrature degree: no SoA kernel, general
    "general": ("cube", 2, "wrap", None),
}


@pytest.mark.parametrize("case", list(LP_CASES))
def test_linear_problem_route_matches_jax(case):
    """LinearProblem tries fold, then "cells", then the general assembler,
    as the JAX package does; the solution and the CG count equal the JAX
    package's."""
    mesh_kind, degree, constraint, _ = LP_CASES[case]
    out = {}
    for name, (pkg, F, M) in PKGS.items():
        mesh = M.create_unit_cube(4, 4, 4) if mesh_kind == "cube" else M.create_unit_square(6, 6)
        V = pkg.functionspace(mesh, ("Lagrange", degree))
        bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(
            V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
        if constraint == "wrap":
            mpc = _periodic(pkg, V, [bc])
        else:
            mpc = _mpc(pkg, V)
            mpc.create_general_constraint(
                {np.array([1.0, 0.5, 0.5]).tobytes(): {np.array([0.0, 0.5, 0.5]).tobytes(): 0.5,
                                                       np.array([0.0, 0.5, 1.0]).tobytes(): 0.5}})
            mpc.finalize()
        a = pkg.BilinearForm(V, lambda u, v, c, F=F: F.inner(F.grad(u), F.grad(v)))
        L = pkg.LinearForm(V, lambda v, c: (1.0 + c.x[0] * c.x[1]) * v.value)
        prob = pkg.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_type": "cg", "ksp_rtol": 1e-12})
        u = prob.solve().x.array
        out[name] = (_route(prob.A), np.asarray(u.numpy() if isinstance(u, torch.Tensor) else u), prob.its)
    expect = case.split()[0]
    assert out["pt"][0] == out["jx"][0] == expect
    assert np.abs(out["pt"][1] - out["jx"][1]).max() < 1e-10
    assert out["pt"][2] == out["jx"][2]
