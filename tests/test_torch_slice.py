"""The main-path slice as a whole (float64, small n): right-hand side,
one GMG V-cycle, GMG-CG and LinearProblem, held against the JAX package on
the same problem and against the explicit K (K^T A K)^-1 K^T b oracle."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem.forms import grad as jgrad, inner as jinner
from dolfinx_mpc_tpu.fem.mesh import create_unit_cube as jx_cube
from dolfinx_mpc_tpu.la.gmg import LatticeGMG as JGMG, build_gmg_hierarchy as jx_hier
from dolfinx_mpc_tpu.la.solvers import cg as jx_cg
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu_torch.fem.forms import grad as pgrad, inner as pinner
from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube as pt_cube
from dolfinx_mpc_tpu_torch.utils import assemble_matrix_scipy, gather_transformation_matrix


def _new_mpc(pkg, V, dtype):
    """pkg.MultiPointConstraint(V, dtype), on the CPU for the port (its
    entry points default to the card)."""
    return pkg.MultiPointConstraint(V, dtype, **({"device": "cpu"} if pkg is pt else {}))


def _problem(pkg, cube, gradf, innerf, n):
    mesh = cube(n, n, n)
    V = pkg.functionspace(mesh, ("Lagrange", 1))
    bdofs = pkg.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0))
    bc = pkg.dirichletbc(0.0, bdofs, V)
    mpc = _new_mpc(pkg, V, np.float64)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0),
        lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pkg.BilinearForm(V, lambda u, v, c: innerf(gradf(u), gradf(v)), quad_degree=1)
    L = pkg.LinearForm(V, lambda v, c: 4.0 * (1.0 + c.x[0] * c.x[2]) * v.value)
    return V, bc, mpc, a, L


def _jx(n):
    return _problem(jx, jx_cube, jgrad, jinner, n)


def _pt(n):
    return _problem(pt, pt_cube, pgrad, pinner, n)


def _oracle(V, bc, mpc, a, L):
    """u = K (K^T A K)^-1 K^T b from the port's host assembler (float64)."""
    A = assemble_matrix_scipy(a, [bc])
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, device="cpu"), [a], [[bc]], None), [bc]).numpy()
    K = gather_transformation_matrix(mpc)
    return A, K @ spla.spsolve((K.T @ A @ K).tocsc(), K.T @ b)


def test_rhs_and_oracle_matrix_match_jax():
    Vj, bcj, mpcj, aj, Lj = _jx(6)
    Vp, bcp, mpcp, ap, Lp = _pt(6)
    bj = np.asarray(jx.set_bc(jx.assemble_vector(Lj, mpcj, dtype=np.float64), [bcj]))
    bp = pt.set_bc(pt.assemble_vector(Lp, mpcp), [bcp])
    assert bp.dtype == torch.float64
    assert np.abs(bp.numpy() - bj).max() < 1e-13 * np.abs(bj).max()
    # the oracle's unconstrained matrix equals the JAX general assembler's
    Aj = jx.assemble_matrix(aj, None, bcs=[bcj], dtype=np.float64).to_scipy()
    Ap = assemble_matrix_scipy(ap, [bcp])
    assert abs(Ap - Aj).max() < 1e-13 * abs(Aj).max()


def _hierarchies(n, n_levels, min_n):
    def mk_j(m):
        V, bc, mpc, a, _ = _jx(m)
        return jx_lattice(a, mpc, bcs=[bc], dtype=np.float64, side_format="fold")

    def mk_p(m):
        V, bc, mpc, a, _ = _pt(m)
        return pt.assemble_matrix_lattice(a, mpc, bcs=[bc], dtype=np.float64,
                                          side_format="fold", device="cpu")

    oj, mj = jx_hier(mk_j, n, n_levels, min_n=min_n)
    op, mp = pt.build_gmg_hierarchy(mk_p, n, n_levels, min_n=min_n)
    kw = dict(smoother="chebyshev", n_pre=2, n_post=2)
    return (oj, JGMG(oj, free_masks=mj, **kw)), (op, pt.LatticeGMG(op, free_masks=mp, **kw))


def test_vcycle_and_gmg_cg_match_jax_and_oracle():
    import jax.numpy as jnp

    (oj, Mj), (op, Mp) = _hierarchies(8, 3, 2)
    assert [o.dia.vshape for o in op] == [o.dia.vshape for o in oj]
    assert np.allclose(Mp._bounds, Mj._bounds, rtol=1e-13)
    r = np.random.default_rng(0).standard_normal(op[0].shape[0])
    # the main path's cycle (Chebyshev smoother, dense coarse inverse) and
    # the other branch (Jacobi smoother, Chebyshev coarse solve)
    Mj2 = JGMG(oj, free_masks=Mj.free_masks, smoother="jacobi", dense_max=8)
    Mp2 = pt.LatticeGMG(op, free_masks=Mp.free_masks, smoother="jacobi", dense_max=8)
    assert (Mj2.coarse_mode, Mp2.coarse_mode) == ("chebyshev", "chebyshev")
    for mj, mp in ((Mj, Mp), (Mj2, Mp2)):
        vj = np.asarray(mj(jnp.asarray(r)))
        vp = mp(torch.as_tensor(r)).numpy()
        assert np.abs(vp - vj).max() < 1e-12 * np.abs(vj).max()

    Vj, bcj, mpcj, _, Lj = _jx(8)
    V, bc, mpc, a, L = _pt(8)
    bj = jnp.asarray(np.asarray(jx.set_bc(jx.assemble_vector(Lj, mpcj, dtype=np.float64), [bcj])))
    b = pt.set_bc(pt.assemble_vector(L, mpc), [bc])
    _, its_j, _ = jx_cg(oj[0].matvec, bj, M=Mj, rtol=1e-12, atol=1e-14, max_it=200)
    x, its, _ = pt.cg(op[0].matvec, b, M=Mp, rtol=1e-12, atol=1e-14, max_it=200)
    assert its == int(its_j)
    u = mpc.finalized.backsubstitution(x).numpy()
    _, u_ref = _oracle(V, bc, mpc, a, L)
    assert np.abs(u - u_ref).max() < 1e-8


@pytest.mark.parametrize("n", [6, 7])
def test_linear_problem_meets_oracle(n):
    V, bc, mpc, a, L = _pt(n)
    opts = {"ksp_type": "cg", "pc_type": "jacobi", "ksp_rtol": 1e-12}
    prob = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options=opts)
    u = prob.solve()
    _, u_ref = _oracle(V, bc, mpc, a, L)
    assert np.abs(u.x.array.numpy() - u_ref).max() < 1e-8
    Vj, bcj, mpcj, aj, Lj = _jx(n)
    pj = jx.LinearProblem(aj, Lj, mpcj, bcs=[bcj], petsc_options=opts)
    pj.solve()
    assert prob.its == pj.its
    # a second solve reuses the value-keyed compiled operator
    n_cached = len(a._compiled_cache)
    prob.solve()
    assert len(a._compiled_cache) == n_cached
