"""The multi-rank dry run of both distributed paths, on spawned ranks.

Counterpart of the JAX package's ``dryrun_multichip`` (``__graft_entry__.py``),
with its six scenarios at its sizes and its assertions, each rank running
them in step over one process group:

1. lattice halo: the periodic Poisson cube at n=12 (2,197 dofs, a
   non-separable source), ShardedLatticeProblem on x-slabs, Jacobi-CG to
   rtol 1e-10;
2. 2-D boxes: the same on a (n/2, 2) rank grid, equal to 1 to 1e-7;
3. two-level GMG: a replicated (6 -> 3) LatticeGMG under the sharded fine
   level, equal to 1 to 1e-7 in fewer iterations;
4. three-level GMG at n=16 (where 16 % (2 n_ranks) == 0): sharded_levels
   1 and 2 agree to 1e-7, the middle-level sharding within 2 iterations of
   the two-level scheme, with a smaller replicated footprint;
5. the general path: ShardedLinearProblem on the n=12 cube, equal to 1 to
   1e-6;
6. tied contact: two stacked P1 vector boxes NB=5 / NT=4 (1,023 dofs),
   elasticity, the general path to rtol 1e-8.

    python -m dolfinx_mpc_tpu_torch.parallel.dryrun [n_ranks] [--cpu]

runs it (gloo ranks; on the CPU with --cpu, else sharing the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .launch import run_ranks

__all__ = ["build_problem", "dryrun_multichip"]


def build_problem(n=8, cube=False, rich_rhs=False, device="cuda"):
    """The JAX dry run's problem: P1 Poisson on the unit square or cube,
    periodic in x, Dirichlet 0 on y = 0 and 1; rich_rhs a non-separable
    source, so that the Krylov solve iterates.  Returns (V, a, L, mpc, bc)."""
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube, create_unit_square

    if cube:
        mesh = create_unit_cube(n, n, n)
        relation = lambda x: np.stack([1.0 - x[0], x[1], x[2]])  # noqa: E731
    else:
        mesh = create_unit_square(n, n)
        relation = lambda x: np.stack([1.0 - x[0], x[1]])  # noqa: E731
    V = dmt.functionspace(mesh, ("Lagrange", 1))
    bc = dmt.dirichletbc(0.0, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)),
                         V)
    mpc = dmt.MultiPointConstraint(V, np.float64, device=device)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0), relation, [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    if rich_rhs:
        L = dmt.LinearForm(V, lambda v, c: (1.0 + torch.sin(5.0 * c.x[0]) * torch.cos(3.0 * c.x[1])
                                            + c.x[-1] ** 2 * c.x[0]) * v.value)
    else:
        L = dmt.LinearForm(V, lambda v, c: 4.0 * v.value)
    return V, a, L, mpc, bc


def contact_problem(nb=5, nt=4, device="cuda"):
    """Two stacked unit boxes (NB^3 and NT^3 P1 vector tets) tied by the
    inelastic contact MPC, clamped at z = 0, pressed by 0.05 at z = 2,
    linear elasticity (mu = 1, lambda = 1.25).  Returns (V, a, L, mpc, bcs)."""
    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import Mesh, create_box, meshtags

    bot = create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                bot.cell_type)
    V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)))
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts][:, :, 2], 1.0).all(axis=1)
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(on_iface & ext)
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    mt = meshtags(mesh, 2, iface, np.where(cz > 1.0, 1, 2))
    mpc = dmt.MultiPointConstraint(V, np.float64, device=device)
    mpc.create_contact_inelastic_condition(mt, 1, 2)
    mpc.finalize()
    bc0 = dmt.dirichletbc(np.zeros(3), dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V)
    bct = dmt.dirichletbc(np.array([0.0, 0.0, -0.05]), dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 2.0)),
                          V)
    a = dmt.BilinearForm(V, lambda u, v, c: 2 * inner(sym(grad(u)), sym(grad(v))) + 1.25 * div(u) * conj(div(v)))
    L = dmt.LinearForm(V, lambda v, c: inner(torch.zeros(3, dtype=c.x.dtype, device=c.x.device), v))
    return V, a, L, mpc, [bc0, bct]


def launch_counts():
    """This process's launch counts of the kernels the distributed paths
    run: K1 (lean-fold assembler), K2 and K7 (DIA SpMVs), K8 (BELL SpMV)."""
    from ..la.bell import bell_matvec
    from ..ops.lattice_kernels import assemble_fold_lean_factored, dia_matvec, dia_matvec_bs

    return {"K1": assemble_fold_lean_factored.launches, "K2": dia_matvec.launches, "K7": dia_matvec_bs.launches,
            "K8": bell_matvec.launches}


def _check(ok, msg):
    """The dry run's assertions, kept under python -O."""
    if not ok:
        raise AssertionError(msg)


def _dryrun_rank(info):
    """The six scenarios on one rank; every rank returns the same numbers
    (its own launch counts aside)."""
    from ..la.gmg import LatticeGMG, build_gmg_hierarchy
    from ..ops.lattice import assemble_matrix_lattice
    from .lattice_spmd import ShardedLatticeProblem
    from .spmd import ShardedLinearProblem, make_device_mesh

    dev, n = info.device, info.world_size
    out = {}
    V, a, L, mpc, bc = build_problem(12, cube=True, rich_rhs=True, device=dev)
    mesh1 = make_device_mesh(device=dev)
    lp = ShardedLatticeProblem(a, L, mpc, [bc], device_mesh=mesh1, rtol=1e-10)
    u1, its1, rn1 = lp.solve()
    u1 = u1.cpu().numpy()
    _check(np.isfinite(u1).all() and its1 >= 20, f"lattice path barely iterated (its={its1}): halo exchange undertested")
    out["lattice-halo"] = dict(dofs=V.num_dofs, slaves=mpc.num_local_slaves, its=its1, rnorm=rn1)

    # 2-D (x, y) boxes: edge and corner vertices owned by up to 4 ranks
    if n >= 4 and n % 2 == 0:
        lp2 = ShardedLatticeProblem(a, L, mpc, [bc], device_mesh=make_device_mesh((n // 2, 2), device=dev),
                                    rtol=1e-10)
        u2, its2, rn2 = lp2.solve()
        err = float(np.abs(u2.cpu().numpy() - u1).max())
        _check(its2 >= 20 and err < 1e-7, f"2-D box decomposition diverges from 1-D slabs (its={its2}, {err:.3e})")
        out["lattice-2d"] = dict(shape=(n // 2, 2), its=its2, rnorm=rn2, err=err)

    def make_level(m):
        _, al, _, mpcl, bcl = build_problem(m, cube=True, device=dev)
        return assemble_matrix_lattice(al, mpcl, bcs=[bcl], side_format="fold", device=dev)

    # two-level GMG: slab-smoothed fine level + replicated coarse hierarchy
    ops_c, masks_c = build_gmg_hierarchy(make_level, 6, 2, min_n=3)
    lg = ShardedLatticeProblem(a, L, mpc, [bc], device_mesh=mesh1, rtol=1e-10, pc_type="gmg",
                               coarse_gmg=LatticeGMG(ops_c, free_masks=masks_c))
    ug, itsg, rng = lg.solve()
    err = float(np.abs(ug.cpu().numpy() - u1).max())
    _check(err < 1e-7 and 2 <= itsg < its1, f"sharded GMG: its={itsg} (Jacobi {its1}), err={err:.3e}")
    out["lattice-gmg"] = dict(its=itsg, rnorm=rng, err=err)

    # sharded_levels=2: the (n/2) middle level in x-slabs too
    if 16 % (2 * n) == 0:
        _, a3, L3, mpc3, bc3 = build_problem(16, cube=True, rich_rhs=True, device=dev)
        ops3, masks3 = build_gmg_hierarchy(make_level, 8, 2, min_n=4)
        cg3 = LatticeGMG(ops3, free_masks=masks3)
        res = {}
        for lvls in (1, 2):
            l3 = ShardedLatticeProblem(a3, L3, mpc3, [bc3], device_mesh=mesh1, rtol=1e-10, pc_type="gmg",
                                       coarse_gmg=cg3, sharded_levels=lvls)
            u3, its3, _ = l3.solve()
            res[lvls] = (u3.cpu().numpy(), its3, l3.memory_report())
        err = float(np.abs(res[2][0] - res[1][0]).max())
        _check(err < 1e-7, f"sharded_levels 2 and 1 differ by {err:.3e}")
        _check(res[2][1] <= res[1][1] + 2, f"sharded_levels=2 took {res[2][1]} its, 1 level {res[1][1]}")
        _check(res[2][2]["replicated_coarse"] < res[1][2]["replicated_coarse"],
               "sharded_levels=2 does not replicate less than sharded_levels=1")
        out["lattice-gmg-3level"] = dict(its=res[2][1], its_2level=res[1][1], err=err,
                                         replicated=res[2][2]["replicated_coarse"],
                                         replicated_2level=res[1][2]["replicated_coarse"])

    prob = ShardedLinearProblem(a, L, mpc, [bc], device_mesh=mesh1, rtol=1e-10)
    u, its, rnorm = prob.solve()
    u = u.cpu().numpy()
    _check(np.isfinite(u).all(), "non-finite solution")
    _check(its >= 20, f"general path barely iterated (its={its})")
    err = float(np.abs(u - u1).max())
    _check(err < 1e-6, f"the two distributed paths disagree by {err:.3e}")
    out["general"] = dict(its=its, rnorm=rnorm, err=err, window=prob._window, dofs=V.num_dofs)

    Vc, ac, Lc, mpc_c, bcs_c = contact_problem(5, 4, device=dev)
    pc = ShardedLinearProblem(ac, Lc, mpc_c, bcs_c, device_mesh=mesh1, rtol=1e-8, max_it=3000)
    uc, itsc, rnc = pc.solve()
    _check(bool(torch.isfinite(uc).all()) and itsc >= 20, f"contact: its={itsc}")
    out["contact"] = dict(dofs=Vc.num_dofs, slaves=mpc_c.num_local_slaves, its=itsc, rnorm=rnc, window=pc._window)
    out["launches"] = launch_counts()
    out["device"] = dev
    return out


def report(n_ranks, out):
    """The dry run's lines, as the JAX package prints them."""
    tag = f"dryrun_multichip({n_ranks})"
    h = out["lattice-halo"]
    lines = [f"{tag} lattice-halo: {h['dofs']} dofs, {h['slaves']} slaves, CG its={h['its']}, rnorm={h['rnorm']:.2e}"]
    if "lattice-2d" in out:
        s = out["lattice-2d"]
        lines.append(f"{tag} lattice-2d ({s['shape'][0]}x{s['shape'][1]} boxes): CG its={s['its']}, "
                     f"rnorm={s['rnorm']:.2e}")
    g = out["lattice-gmg"]
    lines.append(f"{tag} lattice-gmg: CG its={g['its']} (vs {h['its']} Jacobi), rnorm={g['rnorm']:.2e}")
    if "lattice-gmg-3level" in out:
        t = out["lattice-gmg-3level"]
        lines.append(f"{tag} lattice-gmg-3level: CG its={t['its']} (2-level: {t['its_2level']}), replicated coarse "
                     f"{t['replicated']} B (2-level: {t['replicated_2level']} B)")
    s = out["general"]
    lines.append(f"{tag} general: CG its={s['its']}, rnorm={s['rnorm']:.2e}, per-rank window {s['window']} of "
                 f"{s['dofs']} dofs ({100.0 * s['window'] / s['dofs']:.0f}%: distributed vectors, ring ghost rounds)")
    c = out["contact"]
    lines.append(f"{tag} contact: {c['dofs']} dofs, {c['slaves']} slaves, CG its={c['its']}, rnorm={c['rnorm']:.2e}, "
                 f"window {c['window']}/{c['dofs']}")
    return lines


def dryrun_multichip(n_ranks, *, backend, device):
    """Run the six scenarios on n_ranks spawned ranks over `backend` ("gloo"
    or "nccl") with the ranks' tensors on `device` ("cuda" or "cpu"), print
    rank 0's lines and return every rank's results, rank 0 first."""
    outs = run_ranks(_dryrun_rank, n_ranks, backend=backend, device=device)
    for line in report(n_ranks, outs[0]):
        print(line, flush=True)
    return outs


if __name__ == "__main__":
    import sys

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    cpu = "--cpu" in sys.argv
    dryrun_multichip(int(args[0]) if args else 8, backend="gloo", device="cpu" if cpu else "cuda")
