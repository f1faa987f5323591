"""Rank functions of the distributed-path tests (tests/test_torch_spmd.py,
tests/test_torch_lattice_spmd.py, tests/test_torch_multichip.py).  A
spawned rank imports this module to unpickle its function, so it imports
the port alone: never jax, never a test module."""

import numpy as np
import torch

import dolfinx_mpc_tpu_torch as dmt
from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube, create_unit_square
from dolfinx_mpc_tpu_torch.parallel import ShardedLatticeProblem, ShardedLinearProblem, make_device_mesh
from dolfinx_mpc_tpu_torch.parallel.dryrun import contact_problem


def periodic_poisson_2d(n, device="cpu"):
    """tests/test_spmd.py's problem: P1 on the unit square, periodic in x,
    Dirichlet 0.3 on y = 0 and 1, source 1."""
    mesh = create_unit_square(n, n)
    V = dmt.functionspace(mesh, ("Lagrange", 1))
    bc = dmt.dirichletbc(0.3, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)),
                         V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=device)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * 0.0) * v.value)
    return V, a, L, mpc, bc


def periodic_cube(n, bc_value=0.0, quad_degree=None, device="cpu"):
    """P1 on the unit cube, periodic in x, Dirichlet bc_value on y = 0 and 1,
    source 4 (tests/test_lattice_spmd.py's _problem_3d at bc_value 0.5 and
    quad_degree 1, tests/test_spmd.py's 3-D case at 0)."""
    mesh = create_unit_cube(n, n, n)
    V = dmt.functionspace(mesh, ("Lagrange", 1))
    bc = dmt.dirichletbc(bc_value, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                               | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=device)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=quad_degree)
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    return V, a, L, mpc, bc


# ---------------------------------------------------------------------------
# the general path (tests/test_torch_spmd.py)
# ---------------------------------------------------------------------------


def general_rank(info):
    """tests/test_spmd.py's cases on this rank group: the 2-D periodic
    problem at n=12 (with rank 0's host tables), and on 8 ranks the 3-D
    problem at n=3 and tied contact NB=6 / NT=5."""
    mesh = make_device_mesh(device=info.device)
    V, a, L, mpc, bc = periodic_poisson_2d(12)
    prob = ShardedLinearProblem(a, L, mpc, [bc], device_mesh=mesh, rtol=1e-12)
    u, its, rnorm = prob.solve()
    out = {"p2d": dict(u=u.numpy(), its=its, rnorm=rnorm)}
    if info.rank == 0:
        p = prob.pattern
        out["tables"] = dict(indptr=p.indptr, indices=p.indices, row_ids=p.row_ids, part=vars(prob.part),
                             window=prob._window)
    if info.world_size == 8:
        V3, a3, L3, mpc3, bc3 = periodic_cube(3)
        p3 = ShardedLinearProblem(a3, L3, mpc3, [bc3], device_mesh=mesh)
        u3, its3, _ = p3.solve()
        out["cube"] = dict(u=u3.numpy(), its=its3)
        Vc, ac, Lc, mpcc, bcsc = contact_problem(6, 5, device=info.device)
        pc = ShardedLinearProblem(ac, Lc, mpcc, bcsc, device_mesh=mesh, rtol=1e-10, max_it=4000)
        uc, itsc, _ = pc.solve()
        out["contact"] = dict(u=uc.numpy(), its=itsc, window=pc._window, dofs=Vc.num_dofs)
    return out


def collectives_rank(info):
    """RankGrid's collectives on a (2, 2) grid, in float64 and complex128:
    what this rank gets from each."""
    g = make_device_mesh((2, 2), device=info.device)
    r = float(info.rank)
    x = torch.arange(4, dtype=torch.float64) + 10 * r
    z = x * (1 + 2j)
    import sys

    ix, iy = g.coords
    out = dict(coords=g.coords, jax_loaded=any(m == "jax" or m.startswith(("jax.", "dolfinx_mpc_tpu."))
                                               or m == "dolfinx_mpc_tpu" for m in sys.modules),
               psum=g.psum(torch.tensor(r)).item(), psum_x=g.psum(torch.tensor(r), "sx").item(),
               psum_y=g.psum(torch.tensor(r), "sy").item(), pmax=g.pmax(torch.tensor(r)).item(),
               psum_c=g.psum(torch.tensor(r * 1j)).item(),
               scatter=g.psum_scatter(x).numpy(), scatter_c=g.psum_scatter(z).numpy(),
               gather=g.all_gather(x[:2]).numpy(), gather_c=g.all_gather(z[:2]).numpy(),
               ring_x=g.ppermute(x, "sx", g.ring("sx", 1)).numpy(),
               ring_y_c=g.ppermute(z, "sy", g.ring("sy", -1)).numpy(),
               one_way=g.ppermute(x, "sx", [(0, 1)]).numpy())
    return out


def failing_rank(info):
    """Rank 1 raises; the others wait in a collective that never completes."""
    if info.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    make_device_mesh(device=info.device).psum(torch.ones(1))
    return info.rank


# ---------------------------------------------------------------------------
# the lattice path (tests/test_torch_lattice_spmd.py)
# ---------------------------------------------------------------------------


def _levels(device):
    def make_level(m):
        _, al, _, mpcl, bcl = periodic_cube(m, 0.5, 1, device)
        return dmt.assemble_matrix_lattice(al, mpcl, bcs=[bcl], side_format="fold", device=device)

    return make_level


def _solve(prob):
    u, its, rnorm = prob.solve()
    return dict(u=u.numpy(), its=its, rnorm=rnorm)


def bloch_problem(n, device="cpu"):
    """P1 Poisson on the unit cube in complex128 with a Bloch phase
    u(1, y, z) = e^{i pi/3} u(0, y, z), Dirichlet 0.5 on y = 0 and 1,
    source 4 + 2i x."""
    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.5, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)),
                         V)
    mpc = dmt.MultiPointConstraint(V, np.complex128, device=device)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc],
                                               scale=np.exp(1j * np.pi / 3))
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    L = dmt.LinearForm(V, lambda v, c: (4.0 + 2.0j * c.x[0]) * v.value)
    return V, a, L, mpc, bc


# the coarse levels' diagval of the Bloch case: complex, so the middle
# level's slave rows carry it (the JAX package keeps its real part alone,
# parallel/lattice_spmd.py:485)
BLOCH_LEVEL_DIAGVAL = 1.0 + 0.5j


def bloch_levels(device):
    """The Bloch problem's GMG levels: complex128 fold levels of the plain
    periodic identification (a phase is no plane fold), diagval
    BLOCH_LEVEL_DIAGVAL."""
    def make_level(m):
        V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
        bc = dmt.dirichletbc(0.5, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                              | np.isclose(x[1], 1.0)), V)
        mpc = dmt.MultiPointConstraint(V, np.complex128, device=device)
        mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                                   lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
        mpc.finalize()
        a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
        return dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], diagval=BLOCH_LEVEL_DIAGVAL, dtype=np.complex128,
                                           side_format="fold", device=device)

    return make_level


def elasticity_cube(n, device="cpu"):
    """bs=3 P1 elasticity (mu 1, lambda 1.25) on the unit cube, periodic in
    x, clamped on y = 0 and 1, a constant body force."""
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, sym

    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1, (3,)))
    bc = dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                                  | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=device)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)),
                         quad_degree=1)
    L = dmt.LinearForm(V, lambda v, c: v.value[..., 0] + 0.5 * v.value[..., 2])
    return V, a, L, mpc, bc


def coefficient_cube(n, device="cpu"):
    """tests/test_lattice_spmd.py's multi-term form: w grad.grad + mass,
    w = 1 + x0 x1 / 2, Dirichlet 0."""
    V = dmt.functionspace(create_unit_cube(n, n, n), ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)),
                         V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=device)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    w = dmt.Function(V, device=device)
    w.interpolate(lambda x: 1.0 + 0.5 * x[0] * x[1])
    a = dmt.BilinearForm(V, lambda u, v, c: c["w"].value * inner(grad(u), grad(v)), coefficients={"w": w},
                         quad_degree=2) + dmt.BilinearForm(V, lambda u, v, c: inner(u, v), quad_degree=2)
    L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    return V, a, L, mpc, bc


def lattice_rank(info, group):
    """The non-slow cases of tests/test_lattice_spmd.py that run at this
    world size, plus a bs=3 case and the complex Bloch phase at
    sharded_levels=2, by group: "basic" (Jacobi and Chebyshev on slabs and
    boxes) or "gmg" (the GMG cases, memory_report, the Bloch phase); each a
    dict of solution, count and residual."""
    from dolfinx_mpc_tpu_torch.la.gmg import LatticeGMG, build_gmg_hierarchy

    dev, n_dev = info.device, info.world_size
    slabs = make_device_mesh(device=dev)
    out = {}
    if group == "basic":
        V, a, L, mpc, bc = periodic_cube(6, 0.5, 1)
        out["match6"] = _solve(ShardedLatticeProblem(a, L, mpc, [bc], device_mesh=slabs, rtol=1e-12))
        if n_dev == 4:
            V5, a5, L5, mpc5, bc5 = periodic_cube(5, 0.5, 1)
            out["uneven5"] = _solve(ShardedLatticeProblem(a5, L5, mpc5, [bc5], device_mesh=slabs, rtol=1e-12))
            out["boxes(2, 2)"] = _solve(ShardedLatticeProblem(a, L, mpc, [bc],
                                                              device_mesh=make_device_mesh((2, 2), dev), rtol=1e-12))
        if n_dev == 8:
            for shape in ((4, 2), (2, 4)):
                out[f"boxes{shape}"] = _solve(ShardedLatticeProblem(
                    a, L, mpc, [bc], device_mesh=make_device_mesh(shape, dev), rtol=1e-12))
            V7, a7, L7, mpc7, bc7 = periodic_cube(7, 0.5, 1)
            out["uneven_boxes7"] = _solve(ShardedLatticeProblem(a7, L7, mpc7, [bc7],
                                                                device_mesh=make_device_mesh((4, 2), dev), rtol=1e-12))
            V8, a8, L8, mpc8, bc8 = periodic_cube(8, 0.5, 1)
            out["boxes_cheb8"] = _solve(ShardedLatticeProblem(
                a8, L8, mpc8, [bc8], device_mesh=make_device_mesh((2, 4), dev), rtol=1e-11, pc_type="chebyshev",
                cheb_degree=3))
            Vw, aw, Lw, mpcw, bcw = coefficient_cube(6)
            out["coefficient6"] = _solve(ShardedLatticeProblem(aw, Lw, mpcw, [bcw], device_mesh=slabs, rtol=1e-12))
            V32, a32, L32, mpc32, bc32 = periodic_cube(32, 0.5, 1)
            out["jacobi32"] = _solve(ShardedLatticeProblem(a32, L32, mpc32, [bc32], device_mesh=slabs, rtol=1e-10))
            out["cheb32"] = _solve(ShardedLatticeProblem(a32, L32, mpc32, [bc32], device_mesh=slabs, rtol=1e-10,
                                                         pc_type="chebyshev", cheb_degree=3))
            Ve, ae, Le, mpce, bce = elasticity_cube(8)
            out["vector8"] = _solve(ShardedLatticeProblem(ae, Le, mpce, [bce], device_mesh=slabs, rtol=1e-12,
                                                          max_it=5000))
        return out
    if n_dev in (1, 4):
        ops, masks = build_gmg_hierarchy(_levels(dev), 4, 2, min_n=4)
        V8, a8, L8, mpc8, bc8 = periodic_cube(8, 0.5, 1)
        out["gmg8"] = _solve(ShardedLatticeProblem(a8, L8, mpc8, [bc8], device_mesh=slabs, rtol=1e-12, pc_type="gmg",
                                                   coarse_gmg=LatticeGMG(ops, free_masks=masks)))
    if n_dev == 8:
        V32, a32, L32, mpc32, bc32 = periodic_cube(32, 0.5, 1)
        out["jacobi32"] = _solve(ShardedLatticeProblem(a32, L32, mpc32, [bc32], device_mesh=slabs, rtol=1e-10))
        ops, masks = build_gmg_hierarchy(_levels(dev), 16, 3, min_n=4)
        out["gmg32"] = _solve(ShardedLatticeProblem(a32, L32, mpc32, [bc32], device_mesh=slabs, rtol=1e-10,
                                                    pc_type="gmg", coarse_gmg=LatticeGMG(ops, free_masks=masks)))
        V16, a16, L16, mpc16, bc16 = periodic_cube(16, 0.5, 1)
        ops, masks = build_gmg_hierarchy(_levels(dev), 8, 2, min_n=4)
        p = ShardedLatticeProblem(a16, L16, mpc16, [bc16], device_mesh=slabs, rtol=1e-10, pc_type="gmg",
                                  coarse_gmg=LatticeGMG(ops, free_masks=masks))
        out["memory16"] = dict(gmg=p.memory_report(), jacobi=ShardedLatticeProblem(
            a16, L16, mpc16, [bc16], device_mesh=slabs, rtol=1e-10).memory_report())
        ops, masks = build_gmg_hierarchy(_levels(dev), 8, 3, min_n=4)
        cg3 = LatticeGMG(ops, free_masks=masks)
        for lv in (1, 2):
            p = ShardedLatticeProblem(a16, L16, mpc16, [bc16], device_mesh=slabs, rtol=1e-10, pc_type="gmg",
                                      coarse_gmg=cg3, sharded_levels=lv)
            out[f"levels{lv}"] = dict(_solve(p), memory=p.memory_report())
        Vb, ab, Lb, mpcb, bcb = bloch_problem(16)
        ops, masks = build_gmg_hierarchy(bloch_levels(dev), 8, 3, min_n=4)
        pb = ShardedLatticeProblem(ab, Lb, mpcb, [bcb], device_mesh=slabs, dtype=np.complex128, rtol=1e-12,
                                   pc_type="gmg", sharded_levels=2, coarse_gmg=LatticeGMG(ops, free_masks=masks))
        out["bloch16"] = dict(_solve(pb), mid_diagval=pb._mid_dv)
    return out


def card_rank(info):
    """A lattice (Jacobi, n=8), a vector lattice (bs=3, n=6) and a general
    (the 2-D problem, n=12) solve on this rank's device, with the rank's
    launches of K2, K7 and K8 (tests/test_torch_cuda.py: the card against
    the plain path)."""
    from dolfinx_mpc_tpu_torch.parallel.dryrun import launch_counts

    dev = info.device
    slabs = make_device_mesh(device=dev)
    V, a, L, mpc, bc = periodic_cube(8, 0.5, 1, dev)
    out = {"lattice": _solve_on(ShardedLatticeProblem(a, L, mpc, [bc], device_mesh=slabs, rtol=1e-12))}
    Ve, ae, Le, mpce, bce = elasticity_cube(6, dev)
    out["vector"] = _solve_on(ShardedLatticeProblem(ae, Le, mpce, [bce], device_mesh=slabs, rtol=1e-12, max_it=5000))
    V2, a2, L2, mpc2, bc2 = periodic_poisson_2d(12, dev)
    out["general"] = _solve_on(ShardedLinearProblem(a2, L2, mpc2, [bc2], device_mesh=slabs, rtol=1e-12))
    out["launches"] = launch_counts()
    return out


def _solve_on(prob):
    u, its, rnorm = prob.solve()
    return dict(u=u.cpu().numpy(), its=its, rnorm=rnorm)
