"""The JAX package's side of tests/test_torch_lattice_spmd.py and
tests/test_torch_lattice_spmd_gmg.py: its ShardedLatticeProblem on the
same cases, each built once per process.  Imported by those test modules
only, never by a spawned rank."""

import functools

import numpy as np


def jx_cube(n, bc_value=0.5):
    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1))
    bc = dmt.dirichletbc(bc_value, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                               | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    return V, a, L, mpc, bc


def _jx_levels(n, n_levels):
    from dolfinx_mpc_tpu.la.gmg import LatticeGMG, build_gmg_hierarchy
    from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice

    def make_level(m):
        _, al, _, mpcl, bcl = jx_cube(m)
        return assemble_matrix_lattice(al, mpcl, bcs=[bcl], side_format="fold")

    ops, masks = build_gmg_hierarchy(make_level, n, n_levels, min_n=4)
    return LatticeGMG(ops, free_masks=masks)


def jx_mesh(shape):
    import jax
    from jax.sharding import Mesh

    from dolfinx_mpc_tpu.parallel import make_device_mesh

    if isinstance(shape, int):
        return make_device_mesh(shape)
    return Mesh(np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape), ("sx", "sy"))


@functools.lru_cache(maxsize=None)
def jax_case(name, n_dev):
    """(u, its, ShardedLatticeProblem) of one case of torch_spmd_cases.lattice_rank
    through the JAX package."""
    from dolfinx_mpc_tpu.parallel.lattice_spmd import ShardedLatticeProblem

    kw = dict(rtol=1e-12)
    if name == "match6":
        args, mesh = jx_cube(6), n_dev
    elif name == "gmg8":
        args, mesh = jx_cube(8), n_dev
        kw.update(pc_type="gmg", coarse_gmg=_jx_levels(4, 2))
    elif name == "uneven5":
        args, mesh = jx_cube(5), 4
    elif name.startswith("boxes("):
        args, mesh = jx_cube(6), tuple(int(v) for v in name[6:-1].split(","))
    elif name == "uneven_boxes7":
        args, mesh = jx_cube(7), (4, 2)
    elif name == "boxes_cheb8":
        args, mesh = jx_cube(8), (2, 4)
        kw.update(rtol=1e-11, pc_type="chebyshev", cheb_degree=3)
    elif name == "coefficient6":
        args, mesh = _jx_coefficient(6), 8
    elif name in ("jacobi32", "cheb32", "gmg32"):
        args, mesh = jx_cube(32), 8
        kw.update(rtol=1e-10)
        if name == "cheb32":
            kw.update(pc_type="chebyshev", cheb_degree=3)
        if name == "gmg32":
            kw.update(pc_type="gmg", coarse_gmg=_jx_levels(16, 3))
    elif name in ("levels1", "levels2"):
        args, mesh = jx_cube(16), 8
        kw.update(rtol=1e-10, pc_type="gmg", coarse_gmg=_jx_three_levels(), sharded_levels=int(name[-1]))
    elif name == "vector8":
        args, mesh = _jx_elasticity(8), 8
        kw.update(max_it=5000)
    else:
        raise KeyError(name)
    V, a, L, mpc, bc = args
    p = ShardedLatticeProblem(a, L, mpc, [bc], device_mesh=jx_mesh(mesh), **kw)
    u, its, _ = p.solve()
    return np.asarray(u), int(its), p


@functools.lru_cache(maxsize=None)
def _jx_three_levels():
    return _jx_levels(8, 3)


def _jx_coefficient(n):
    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner

    V, _, L, mpc, _ = jx_cube(n, 0.0)
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                          | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    w = dmt.Function(V)
    w.interpolate(lambda x: 1.0 + 0.5 * x[0] * x[1])
    a = dmt.BilinearForm(V, lambda u, v, c: c["w"].value * inner(grad(u), grad(v)), coefficients={"w": w},
                         quad_degree=2) + dmt.BilinearForm(V, lambda u, v, c: inner(u, v), quad_degree=2)
    return V, a, L, mpc, bc


def _jx_elasticity(n):
    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1, (3,)))
    bc = dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                                  | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)),
                         quad_degree=1)
    L = dmt.LinearForm(V, lambda v, c: v.value[..., 0] + 0.5 * v.value[..., 2])
    return V, a, L, mpc, bc
