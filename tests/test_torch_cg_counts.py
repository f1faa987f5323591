"""CG iteration counts of the full-size lattice paths on the CPU: the port's
CPU path (device="cpu", the kernels' plain versions) against the JAX
package on the CPU (XLA), on the same problem in float32 (the counts that
chip_smoke.py gates the card's runs against, ±2) and in float64 (where
the two must take the same count).

Marked ``slow`` (full-size problems, minutes each; Tier-1 deselects them):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cg_counts.py -m slow -s -q
"""

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem.forms import conj as jconj, div as jdiv, grad as jgrad, inner as jinner, sym as jsym
from dolfinx_mpc_tpu.fem.mesh import create_unit_cube as jx_cube
from dolfinx_mpc_tpu.la.gmg import LatticeGMG as JxGMG, build_gmg_hierarchy as jx_hierarchy
from dolfinx_mpc_tpu.la.solvers import cg as jx_cg
from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice as jx_lattice
from dolfinx_mpc_tpu_torch.fem.forms import conj as pconj, div as pdiv, grad as pgrad, inner as pinner, sym as psym
from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube as pt_cube

pytestmark = pytest.mark.slow


def _clf(pkg, m, bs, dtype=np.float32):
    """bench.py's make_problem through either package in `dtype`: P1 scalar
    Poisson (bs 1) or P1 elasticity with mu 1, lambda 1.25 (bs 3), periodic
    in x, Dirichlet on the y-planes."""
    port = pkg is pt
    cube, grad, inner = (pt_cube, pgrad, pinner) if port else (jx_cube, jgrad, jinner)
    dev = {"device": "cpu"} if port else {}
    V = pkg.functionspace(cube(m, m, m), ("Lagrange", 1) if bs == 1 else ("Lagrange", 1, (3,)))
    bc = pkg.dirichletbc(0.0 if bs == 1 else np.zeros(3), pkg.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = pkg.MultiPointConstraint(V, dtype=dtype, **dev)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    if bs == 1:
        a = pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    else:
        sym, div, conj = (psym, pdiv, pconj) if port else (jsym, jdiv, jconj)
        a = pkg.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v)))
                             + 1.25 * div(u) * conj(div(v)), quad_degree=1)
    lat = pt.assemble_matrix_lattice if port else jx_lattice
    return V, bc, mpc, lat(a, mpc, bcs=[bc], dtype=dtype, side_format="fold", **dev)


def _u0(clf, dtype):
    """bench.py:504-515's manufactured u0 (components interleaved)."""
    n0, n1, n2 = clf.vshape
    ax = [np.arange(m, dtype=np.float32) / m for m in (n0, n1, n2)]
    pat = (np.sin(np.pi * ax[0])[:, None, None] * np.sin(np.pi * ax[1])[None, :, None]
           * np.sin(2 * np.pi * ax[2])[None, None, :]).astype(np.float32)
    keep = np.asarray(clf._keep_grid, np.float32)
    return np.moveaxis(pat[None] * keep, 0, -1).reshape(-1).astype(dtype)


def _counts(bs, n, dtype):
    """(port its, JAX its) of GMG-CG at rtol 1e-6: P1 with b from
    assemble_vector + set_bc and Chebyshev 2+2, bs=3 with b = A u0 and
    Chebyshev 3+3, 4 levels down to 9^3, dense coarse inverse."""
    import jax

    sweeps = 2 if bs == 1 else 3
    out = []
    for pkg in (pt, jx):
        port = pkg is pt
        V, bc, mpc, clf = _clf(pkg, n, bs, dtype)
        A = clf.assemble()
        if bs == 1:
            L = pkg.LinearForm(V, lambda v, c: 4.0 * v.value)
            kw = {"device": "cpu"} if port else {}
            b = pkg.set_bc(pkg.assemble_vector(L, mpc, dtype=dtype, **kw), [bc])
        else:
            u0 = _u0(clf, dtype)
            b = A.matvec(torch.as_tensor(u0) if port else jax.numpy.asarray(u0))
        make = lambda m: clf if m == n else _clf(pkg, m, bs, dtype)[3]  # noqa: E731
        if port:
            ops, masks = pt.build_gmg_hierarchy(make, n, 4, min_n=8)
            ops[0] = A
            M = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev", n_pre=sweeps, n_post=sweeps)
            its = pt.cg(A.matvec, b, M=M, rtol=1e-6, atol=1e-12, max_it=3000)[1]
        else:
            ops, masks = jx_hierarchy(make, n, 4, min_n=8)
            ops[0] = A
            M = JxGMG(ops, free_masks=masks, smoother="chebyshev", n_pre=sweeps, n_post=sweeps)
            its = jax.jit(lambda A_, M_, b_: jx_cg(A_.matvec, b_, M=M_, rtol=1e-6, atol=1e-12,
                                                   max_it=3000))(A, M, b)[1]
        out.append(int(its))
    return tuple(out)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bs,n", [(1, 64), (3, 64)])
def test_cpu_cg_count_of_the_port_matches_jax(bs, n, dtype):
    """The port's CPU path takes the JAX package's CG count in float64, and
    in float32 stays within chip_smoke.py's gate of it (±2): at P1 n=64 the
    port takes 11 in float32 on the CPU as on the card, the JAX package 12,
    and both take 11 in float64."""
    port, jax_its = _counts(bs, n, dtype)
    print(f"bs={bs} n={n} {np.dtype(dtype).name}: CG its port CPU {port}, JAX CPU {jax_its}")
    if dtype == np.float64:
        assert port == jax_its
    else:
        assert abs(port - jax_its) <= 2
