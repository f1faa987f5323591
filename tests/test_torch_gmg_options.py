"""Geometric multigrid over "cells" side-format levels and every LatticeGMG
constructor option, against the JAX package on the CPU (float64): the
port's counterpart of tests/test_gmg.py::test_gmg_beats_jacobi_and_scales
on "cells" levels with the JAX package's CG counts, and one V-cycle
application per option equal to the JAX package's."""

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as JF
from dolfinx_mpc_tpu.fem import mesh as JM
from dolfinx_mpc_tpu.la.gmg import LatticeGMG as JGMG, build_gmg_hierarchy as jx_hierarchy
from dolfinx_mpc_tpu.la.solvers import cg as jx_cg, jacobi_preconditioner as jx_jacobi
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu_torch.fem import forms as PF
from dolfinx_mpc_tpu_torch.fem import mesh as PM
from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner


def _make(pkg, F, M, n, fmt="cells"):
    """tests/test_gmg.py's level: P1 Poisson on the unit cube, Dirichlet on
    the y-planes, periodic in x, in side format `fmt`."""
    V = pkg.functionspace(M.create_unit_cube(n, n, n), ("Lagrange", 1))
    bc = pkg.dirichletbc(0.0, pkg.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    dev = {"device": "cpu"} if pkg is pt else {}
    mpc = pkg.MultiPointConstraint(V, np.float64, **dev)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pkg.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)), quad_degree=1)
    if pkg is pt:
        return pt.assemble_matrix_lattice(a, mpc, bcs=[bc], side_format=fmt, device="cpu"), V
    return jx_lattice(a, mpc, bcs=[bc], side_format=fmt), V


def _jx(n):
    return _make(jx, JF, JM, n)


def _pt(n):
    return _make(pt, PF, PM, n)


def test_gmg_beats_jacobi_and_scales():
    """tests/test_gmg.py::test_gmg_beats_jacobi_and_scales at n = 8 and 16
    on "cells" levels: the port's Jacobi-CG and GMG-CG counts equal the
    JAX package's, GMG takes under a third of Jacobi's and grows at most
    1.8x from n = 8 to 16, and both solutions agree."""
    import jax.numpy as jnp

    its = {}
    for n in (8, 16):
        oj, mj = jx_hierarchy(lambda m: _jx(m)[0], n, 4)
        op, mp = pt.build_gmg_hierarchy(lambda m: _pt(m)[0], n, 4)
        assert op[0].side_Aep is not None and [o.dia.vshape for o in op] == [o.dia.vshape for o in oj]
        b = np.random.default_rng(0).standard_normal(op[0].shape[0])
        A = op[0]
        xj, itj, _ = pt.cg(A.matvec, torch.as_tensor(b), M=jacobi_preconditioner(A.diagonal()), rtol=1e-10,
                           max_it=3000)
        xg, itg, _ = pt.cg(A.matvec, torch.as_tensor(b), M=pt.LatticeGMG(op, free_masks=mp), rtol=1e-10, max_it=3000)
        assert np.abs(xj.numpy() - xg.numpy()).max() < 1e-6
        Aj, bj = oj[0], jnp.asarray(b)
        _, itj_j, _ = jx_cg(Aj.matvec, bj, M=jx_jacobi(Aj.diagonal()), rtol=1e-10, max_it=3000)
        _, itg_j, _ = jx_cg(Aj.matvec, bj, M=JGMG(oj, free_masks=mj), rtol=1e-10, max_it=3000)
        assert (itj, itg) == (int(itj_j), int(itg_j))
        assert itg < itj / 3, f"n={n}: GMG {itg} vs Jacobi {itj}"
        its[n] = itg
    assert its[16] <= its[8] * 1.8, its


@pytest.fixture(scope="module")
def hierarchies():
    oj, mj = jx_hierarchy(lambda m: _jx(m)[0], 8, 3, min_n=2)
    op, mp = pt.build_gmg_hierarchy(lambda m: _pt(m)[0], 8, 3, min_n=2)
    return (oj, mj), (op, mp)


BOUNDS = [2.7, 2.5, 2.3]
OPTIONS = {
    "omega": dict(omega=0.6),
    "coarse dense": dict(coarse="dense"),
    "coarse auto -> chebyshev": dict(coarse="auto", dense_max=8),
    "coarse chebyshev": dict(coarse="chebyshev"),
    "cheb_degree": dict(coarse="chebyshev", cheb_degree=12),
    "coarse cg": dict(coarse="cg"),
    "coarse cg, coarse_iters": dict(coarse="cg", coarse_iters=7),
    "bounds": dict(bounds=BOUNDS, smoother="chebyshev", coarse="chebyshev"),
    "coarse_inv": dict(coarse="dense", coarse_inv="given"),
    "chebyshev smoother": dict(smoother="chebyshev", n_pre=3, n_post=3),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_gmg_option_matches_jax(hierarchies, option):
    """One V-cycle application with each JAX constructor option equals the
    JAX package's to 1e-12 (relative to its largest entry)."""
    import jax.numpy as jnp

    (oj, mj), (op, mp) = hierarchies
    kw = dict(OPTIONS[option])
    kw_p = dict(kw)
    if kw.get("coarse_inv") == "given":
        # the same explicit coarse inverse in both (a symmetric matrix, not
        # the operator's own inverse: the cycle must use what it is given)
        n = op[-1].shape[0]
        C = np.random.default_rng(4).standard_normal((n, n))
        C = (C + C.T) / n
        kw["coarse_inv"], kw_p["coarse_inv"] = jnp.asarray(C), C
    Mj = JGMG(oj, free_masks=mj, **kw)
    Mp = pt.LatticeGMG(op, free_masks=mp, **kw_p)
    assert Mp.coarse_mode == Mj.coarse_mode and np.allclose(Mp.omegas, Mj.omegas, rtol=1e-13)
    if option == "bounds":
        assert Mp._bounds == BOUNDS
    r = np.random.default_rng(1).standard_normal(op[0].shape[0])
    vj = np.asarray(Mj(jnp.asarray(r)))
    vp = Mp(torch.as_tensor(r)).numpy()
    assert np.abs(vp - vj).max() < 1e-12 * np.abs(vj).max()


@pytest.mark.parametrize("kw", [dict(smoother="chebyshev", coarse="dense"),
                                dict(smoother="chebyshev", coarse="chebyshev"), dict(smoother="jacobi")],
                         ids=["chebyshev dense", "chebyshev chebyshev", "jacobi"])
def test_gmg_tail_is_the_cycle_below(hierarchies, kw):
    """tail(1) of a three-level hierarchy is its V-cycle from level 1, bit
    for bit: the same level objects, the level's own span names (gmg.L1.*)
    and a graph table of its own."""
    from dolfinx_mpc_tpu_torch.utils import timing as tt

    (_, _), (op, mp) = hierarchies
    M = pt.LatticeGMG(op, free_masks=mp, **kw)
    T = M.tail(1)
    assert len(op) == 3 and len(T.ops) == 2 and all(a is b for a, b in zip(T.ops, M.ops[1:]))
    assert all(a is b for a, b in zip(T.free_masks, M.free_masks[1:])) and T._graphs is not M._graphs
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(op[1].shape[0]))
    tt.reset_timings()
    y = T(r)
    spans = {k for k in tt.trace_timings() if k.startswith("gmg.L")}
    assert spans == {f"gmg.L1.{phase}" for phase in ("pre", "down", "up", "post")}
    assert torch.equal(y, M._vcycle(1, r)) and torch.equal(T._vcycle(0, r), y)
    with pytest.raises(ValueError, match="tail"):
        M.tail(3)


def test_gmg_rejects_unknown_coarse_mode(hierarchies):
    (_, _), (op, mp) = hierarchies
    with pytest.raises(ValueError, match="coarse mode"):
        pt.LatticeGMG(op, free_masks=mp, coarse="lu")
