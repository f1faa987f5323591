"""The port's counterpart of tests/test_dtypes.py: the constrained pipeline at
float32, float64, complex64 and complex128 (conftest's full_scalar_dtype),
each case through both packages on the same inputs.

Each test holds the port to the JAX test's own oracle checks at
conftest.dtype_tol (2e-4 single, 1e-8 double) and to the JAX package's
values on the same problem: relative 5e-6 in float32 / complex64 (another
summation order) and 1e-12 in float64 / complex128.
"""

import numpy as np
import scipy.sparse.linalg as spla

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as JF
from dolfinx_mpc_tpu.fem import mesh as JM
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu.utils import gather_transformation_matrix as jx_K
from dolfinx_mpc_tpu_torch._dtypes import torch_dtype
from dolfinx_mpc_tpu_torch.fem import forms as PF
from dolfinx_mpc_tpu_torch.fem import mesh as PM
from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs, compare_mpc_rhs, gather_transformation_matrix

from conftest import dtype_tol

PKGS = {"jx": (jx, JF, JM), "pt": (pt, PF, PM)}


def _parity_tol(dtype):
    return 5e-6 if dtype_tol(dtype) > 1e-6 else 1e-12


def _wide(dtype):
    return np.complex128 if np.dtype(dtype).kind == "c" else np.float64


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _kw(pkg):
    return {"device": "cpu"} if pkg == "pt" else {}


def _problem(pkg, dtype, cube=False):
    """tests/test_dtypes.py's _problem in package `pkg`."""
    mod, F, M = PKGS[pkg]
    if cube:
        mesh = M.create_unit_cube(3, 3, 3)
        relation = lambda x: np.stack([1.0 - x[0], x[1], x[2]])  # noqa: E731
    else:
        mesh = M.create_unit_square(5, 5)
        relation = lambda x: np.stack([1.0 - x[0], x[1]])  # noqa: E731
    V = mod.functionspace(mesh, ("Lagrange", 1))
    bdofs = mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0))
    bc = mod.dirichletbc(0.3, bdofs, V)
    mpc = mod.MultiPointConstraint(V, dtype=dtype, **_kw(pkg))
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0), relation, [bc])
    mpc.finalize()
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)) + F.inner(u, v))
    L = mod.LinearForm(V, lambda v, c: (1.0 + c.x[0]) * v.value)
    return V, a, L, mpc, bc


def test_matrix_assembly_all_dtypes(full_scalar_dtype):
    """The general assembler at every scalar type: the K^H A K oracle at
    dtype_tol, the dtype kept, the JAX package's values."""
    dtype = full_scalar_dtype
    V, a, L, mpc, bc = _problem("pt", dtype)
    A_mpc = pt.assemble_matrix(a, mpc, bcs=[bc], dtype=dtype).to_scipy()
    assert A_mpc.dtype == np.dtype(dtype)
    A_org = pt.assemble_matrix(a, None, bcs=[bc], dtype=_wide(dtype), device="cpu").to_scipy()
    compare_mpc_lhs(A_org, A_mpc.astype(A_org.dtype), mpc, atol=dtype_tol(dtype))
    Vj, aj, Lj, mj, bcj = _problem("jx", dtype)
    A_j = jx.assemble_matrix(aj, mj, bcs=[bcj], dtype=dtype).to_scipy()
    assert abs(A_mpc - A_j).max() <= _parity_tol(dtype) * abs(A_j).max()


def test_vector_and_solve_all_dtypes(full_scalar_dtype):
    """K^H b at every scalar type against the oracle and the JAX package's
    vector, then LinearProblem (the lattice fold path on the unit square)
    against the wide-dtype K (K^H A K)^-1 K^H b within 50 dtype_tol, as
    the JAX test holds the JAX package's."""
    dtype = full_scalar_dtype
    tol = dtype_tol(dtype)
    rdt = _wide(dtype)
    V, a, L, mpc, bc = _problem("pt", dtype)
    b_mpc = pt.assemble_vector(L, mpc, dtype=dtype).numpy()
    assert b_mpc.dtype == np.dtype(dtype)
    b_org = pt.assemble_vector(L, None, dtype=rdt, device="cpu").numpy()
    compare_mpc_rhs(b_org, b_mpc.astype(rdt), mpc, atol=10 * tol)
    Vj, aj, Lj, mj, bcj = _problem("jx", dtype)
    assert _rel(b_mpc, jx.assemble_vector(Lj, mj, dtype=dtype)) <= _parity_tol(dtype)

    opts = {"ksp_rtol": 1e-6 if tol > 1e-6 else 1e-12}
    u = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options=opts).solve().x.array.numpy()
    A = pt.assemble_matrix(a, None, bcs=[bc], dtype=rdt, device="cpu").to_scipy()
    b = pt.assemble_vector(L, None, dtype=rdt, device="cpu")
    b = pt.set_bc(pt.apply_lifting(b, [a], [[bc]], None, dtype=rdt, device="cpu"), [bc]).numpy()
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.conj().T @ A @ K).tocsc(), K.conj().T @ b)
    assert np.abs(u - u_ref).max() < 50 * tol
    # the JAX test holds the JAX package's solution to the same oracle, on
    # the same K
    assert abs(K - jx_K(mj)).max() == 0


def test_lattice_all_dtypes(full_scalar_dtype):
    """The DIA fast path at every scalar type (the 3-D periodic fold): the
    real types through the CUDA assemblers' plain versions, the complex
    ones through the element-kernel lean path, as the JAX package routes
    them; equal to the general assembler within 10 dtype_tol and to the
    JAX package's lattice operator."""
    dtype = full_scalar_dtype
    tol = dtype_tol(dtype)
    V, a, L, mpc, bc = _problem("pt", dtype, cube=True)
    clf = pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=dtype, side_format="fold", device="cpu")
    assert clf._route == ("lean" if np.dtype(dtype).kind == "c" else "kernel")
    A = clf.assemble()
    assert A.dia.data.dtype == torch_dtype(dtype)
    A_lat = A.to_scipy()
    A_gen = pt.assemble_matrix(a, mpc, bcs=[bc], dtype=dtype).to_scipy()
    assert abs(A_lat - A_gen).max() < 10 * tol
    Vj, aj, Lj, mj, bcj = _problem("jx", dtype, cube=True)
    A_j = jx_lattice(aj, mj, bcs=[bcj], dtype=dtype, side_format="fold").assemble().to_scipy()
    assert abs(A_lat - A_j).max() <= _parity_tol(dtype) * abs(A_j).max()
