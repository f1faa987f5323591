"""Sharded lattice solve: (x, y)-box domain decomposition with point-to-point
halos over the ranks of a ``torch.distributed`` group (1-D x-slabs are the
Dy = 1 case of the same program).

Counterpart of ``dolfinx_mpc_tpu/parallel/lattice_spmd.py``, one process
per rank (parallel/comm.py) where the JAX package runs one ``shard_map``
program.  The vertex lattice is cut into (x, y) boxes over the (Dx, Dy)
rank grid, shared vertex planes DUPLICATED on all owners; each rank builds
the host tables of its own box only:

- assembly: every rank runs the cells-last SoA element kernel
  (ops/soa_kernels.py) and the stencil accumulation on its cell box;
  duplicated-plane partials are summed dimension by dimension — one
  two-way exchange in x, then one in y over the x-completed planes, so
  edge and corner vertices (up to 4 owners) complete with no extra
  messages;
- SpMV: the box's stencil is held on the halo-extended box (one plane more
  on each side in x, and in y where Dy > 1) with zero data on the halo, so
  the product is one DIA SpMV on that box — kernel K2 (bs = 1) or K7
  (bs = 2, 3) on the card, through ``DIAMatrix`` — after gathering the halo
  planes, x first, then the y rows of the x-extended array (which carry
  the diagonal neighbours' corners);
- the MPC side matrix (slave-cell K^H A_e K couplings, reaching across the
  domain): a replicated O(surface) vector made with one all-reduce over
  both axes; the x values it needs, one all-reduce of an O(surface) packed
  vector per matvec;
- dot products: plane-weighted local partials and one all-reduce; a
  duplicated plane counts on its LEFT owner in each axis;
- preconditioners: Jacobi, Chebyshev-Jacobi on the Gershgorin bound (a
  max all-reduce), and the sharded two- and three-level GMG: slab-smoothed
  fine level, the (n/2) middle level sharded too at sharded_levels=2, and
  the replicated coarse ``LatticeGMG`` (K2 on its levels; at
  sharded_levels=2 its ``tail(1)``, the levels below the middle one) fed by
  one all-reduce of the restricted residual.

Everything — assembly, CG, backsubstitution — runs on every rank in step;
each rank's tensors live on its device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._dtypes import torch_dtype
from ..fem.forms import Form
from ..la.gmg import _prolong1, _restrict1
from ..la.solvers import ChebyshevPC
from ..la.sparse import build_slot_pattern
from ..ops.assemble import _bc_masks, _build_cell_transforms, _mpc_pair, _real_dtype, apply_lifting, assemble_vector, \
    set_bc
from ..ops.lattice import DIAMatrix, _scalar, _vertex_delta_table, get_lattice_info
from ..ops.soa_kernels import compile_cell_kernel_soa
from .comm import RankGrid
from .spmd import make_device_mesh

__all__ = ["ShardedLatticeProblem"]


def _tensor_bytes(obj, seen=None):
    """Bytes of the distinct tensors reachable from obj through lists,
    tuples, dicts and the attributes of the port's own objects: a
    LatticeGMG's levels, masks and inverses."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.numel(), obj.dtype)
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    if type(obj).__module__.startswith("dolfinx_mpc_tpu_torch") and id(obj) not in seen:
        seen.add(id(obj))
        return sum(_tensor_bytes(v, seen) for v in vars(obj).values())
    return 0


def _transfer_tables(d, nxc, n_last, wx_d, rdt):
    """A slab's x-transfer tables for its nxc + 1 local planes (global
    planes d*nxc + p, padding past n_last excluded): restriction scatter
    (coarse plane, left-owner weight) of the even planes, prolongation
    gather (lo, hi, weights) of every plane."""
    r_idx = np.zeros(nxc + 1, np.int64)
    r_w = np.zeros(nxc + 1, rdt)
    p_lo = np.zeros(nxc + 1, np.int64)
    p_hi = np.zeros(nxc + 1, np.int64)
    p_wlo = np.zeros(nxc + 1, rdt)
    p_whi = np.zeros(nxc + 1, rdt)
    for p in range(nxc + 1):
        g_ = d * nxc + p
        if g_ > n_last:
            continue
        if g_ % 2 == 0:
            r_idx[p] = g_ // 2
            r_w[p] = wx_d[p]
            p_lo[p] = g_ // 2
            p_wlo[p] = 1.0
        else:
            p_lo[p] = (g_ - 1) // 2
            p_hi[p] = (g_ + 1) // 2
            p_wlo[p] = 0.5
            p_whi[p] = 0.5
    return r_idx, r_w, p_lo, p_hi, p_wlo, p_whi


def _axis_weights(D, nc, n_last, rdt):
    """(D, nc + 1) plane weights: a shared plane counts on its LEFT owner,
    planes past the global extent (padding) weigh 0."""
    w = np.ones((D, nc + 1), rdt)
    w[:, 0] = 0.0
    w[0, 0] = 1.0
    for d in range(D):
        for p in range(nc + 1):
            if d * nc + p > n_last:
                w[d, p] = 0.0
    return w


class ShardedLatticeProblem:
    """Distributed lattice Poisson-type solve over a 1-D or 2-D rank grid.

    device_mesh: a RankGrid (parallel.make_device_mesh): (world, 1) for
    x-slabs or (Dx, Dy) for (x, y) boxes.  pc_type "jacobi", "chebyshev"
    (degree cheb_degree on the Gershgorin bound) or "gmg" (x-slabs only;
    coarse_gmg: a LatticeGMG whose finest level is the (n/2) grid, held by
    every rank; sharded_levels=2 shards its finest level too).  Every rank
    constructs the problem from the same inputs and calls solve() together.
    """

    def __init__(self, a: Form, L: Form, mpc, bcs=None, device_mesh: RankGrid = None, dtype=np.float64, rtol=1e-8,
                 max_it=3000, diagval=1.0, pc_type="jacobi", cheb_degree=3, cheb_power_iters=20, coarse_gmg=None,
                 gmg_pre=2, gmg_post=2, gmg_omega=0.8, sharded_levels=1):
        comm = device_mesh if device_mesh is not None else make_device_mesh()
        self.device_mesh = comm
        dev = comm.device
        self.device = dev
        Dx, Dy = comm.shape
        self.Dx, self.Dy = Dx, Dy
        mx, my = comm.coords
        bcs = bcs or []
        mpc_r, _ = _mpc_pair(mpc)
        V = a.test_space
        mesh = V.mesh
        lat = get_lattice_info(mesh)
        if lat is None:
            raise ValueError("ShardedLatticeProblem needs a lattice mesh")
        dtype = np.dtype(dtype)
        self.dtype = dtype
        rdt = _real_dtype(dtype)
        tdt, trdt = torch_dtype(dtype), torch_dtype(rdt)
        self.V, self.mpc = V, mpc_r
        nx, ny, nz_ = lat.dims
        is2d = mesh.tdim == 2
        nzc = 1 if is2d else nz_
        n1, n2 = ny + 1, (1 if is2d else nz_ + 1)
        bs = V.block_size
        T = lat.cells_per_box
        self.bs, self.T = bs, T
        self.vshape = (nx + 1, n1, n2)
        self.rtol, self.max_it = rtol, max_it
        self.diagval = diagval
        self.pc_type = pc_type
        self.cheb_degree = int(cheb_degree)
        self.cheb_power_iters = int(cheb_power_iters)
        self.coarse_gmg = coarse_gmg
        self.gmg_pre, self.gmg_post = int(gmg_pre), int(gmg_post)
        self.gmg_omega = float(gmg_omega)
        self.sharded_levels = int(sharded_levels)
        if pc_type == "gmg":
            # sharded two-level scheme: the fine level is smoothed and
            # restricted in x-slabs; the (n/2)-and-down hierarchy runs
            # REPLICATED on every rank.  sharded_levels=2 keeps the (n/2)
            # MIDDLE level in x-slabs too (its operator sliced from
            # coarse_gmg.ops[0], the periodic fold by two single-plane
            # messages between the end ranks): only the (n/4)-and-down tail
            # is replicated.
            if coarse_gmg is None:
                raise ValueError("pc_type='gmg' needs coarse_gmg")
            if Dy != 1 or is2d:
                raise ValueError("sharded gmg: 3-D lattices on 1-D x-slab rank grids only")
            if nx % 2 or ny % 2 or nz_ % 2:
                raise ValueError("gmg two-level needs even lattice dims")
            c0 = coarse_gmg.ops[0].dia.vshape
            if c0 != (nx // 2 + 1, ny // 2 + 1, nz_ // 2 + 1):
                raise ValueError(f"coarse hierarchy finest level {c0} != half-resolution grid")
            if self.sharded_levels not in (1, 2):
                raise ValueError("sharded_levels is 1 or 2")
        else:
            self.sharded_levels = 1

        # one SoA kernel per cell term; their element tensors sum
        if not all(t.integral == "cell" and t.entities is None for t in a.terms):
            raise ValueError("sharded lattice path: full-domain cell integrals only")
        self.kernels = []
        self._coeff_meta = []  # per term: (name, nd_w, bs_w, W, fn)
        for t in a.terms:
            k = compile_cell_kernel_soa(mesh, V, V, t, dtype)
            if k is None:
                raise ValueError("form term not supported by the SoA kernel (ops.soa_kernels.soa_supported)")
            self.kernels.append(k)
            self._coeff_meta.append([(nme, fn.function_space.element.ndofs, fn.function_space.block_size,
                                      fn.function_space, fn) for nme, fn in t.coefficients.items()])

        # ---- box partition ----------------------------------------------
        nxc = -(-nx // Dx)  # x cells per rank (last padded)
        nyc = -(-ny // Dy)  # y cells per rank (last padded)
        self.nxc, self.nyc = nxc, nyc
        nd = V.ndofs_cell
        c_loc = nxc * nyc * nzc * T

        def as_t(arr, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=dt, device=dev)

        tr = _build_cell_transforms(V, mpc_r, dtype)
        bc_mask = _bc_masks(V, bcs, dtype)
        dm_ = V.dofmap  # (c, nd)
        cells_grid = np.arange(mesh.num_cells).reshape(nx, ny, nzc, T)

        # the cell ids of this rank's box, padded to the full (nxc, nyc,
        # nzc, T) local grid, and the validity mask of the padding
        i0, i1 = mx * nxc, min((mx + 1) * nxc, nx)
        j0, j1 = my * nyc, min((my + 1) * nyc, ny)
        ci, cj = max(i1 - i0, 0), max(j1 - j0, 0)  # a box may be all padding
        ids = np.zeros((nxc, nyc, nzc, T), np.int64)
        vm = np.zeros((nxc, nyc, nzc, T), rdt)
        if ci and cj:
            ids[:ci, :cj] = cells_grid[i0:i1, j0:j1]
            vm[:ci, :cj] = 1.0
        ids, vm = ids.reshape(-1), vm.reshape(-1)
        self._coords_sh = as_t(mesh.points[mesh.cells[ids]].transpose(1, 2, 0), trdt)  # (nv, g, c_loc)
        self._w_cell = as_t((1.0 - tr.slave_cell_mask[ids].astype(rdt)) * vm, trdt)
        self._keep_sh = as_t((1.0 - bc_mask[dm_[ids]]).T, trdt)  # (nd, c_loc)

        # per term: this box's coefficient locals (nd_w, bs_w, c_loc)
        self._wl_sh = []
        for metas in self._coeff_meta:
            term_wl = {}
            for nme, nd_w, bs_w, W, fn in metas:
                wcell = fn.x.array.detach().cpu().numpy().astype(dtype)[W.dofmap[ids]]  # (c_loc, nd_w*bs_w)
                term_wl[nme] = as_t(wcell.reshape(-1, nd_w, bs_w).transpose(1, 2, 0), tdt)
            self._wl_sh.append(term_wl)

        # stencil moves (same derivation as ops/lattice.py)
        deltas = _vertex_delta_table(mesh, lat)
        nv = deltas.shape[1]
        offs = {}
        moves = []
        for t in range(T):
            for a_ in range(nv):
                for b_ in range(nv):
                    off = tuple(int(x) for x in (deltas[t, b_] - deltas[t, a_]))
                    oid = offs.setdefault(off, len(offs))
                    moves.append((t, a_, b_, oid, tuple(int(x) for x in deltas[t, a_])))
        self.offsets = tuple(offs.keys())
        self.moves = moves
        # the moves grouped by (offset, corner delta): one summed slice add
        # per (group, ci, cj) at assembly
        grouped = {}
        for t, a_, b_, oid, da in moves:
            grouped.setdefault((oid, da), []).append((t, a_, b_))
        self._groups = [(oid, da, *(as_t(v) for v in zip(*tab))) for (oid, da), tab in grouped.items()]

        # per-rank diag additions (bc diagval), shared planes on all owners
        bc_dofs = np.unique(np.concatenate([bc.dofs for bc in bcs])) if bcs else np.zeros(0, np.int64)
        dg = np.zeros(V.num_dofs, dtype)
        dg[bc_dofs] = diagval
        self._diag_sh = as_t(self._to_box(dg.reshape(nx + 1, n1, n2, bs), mx, my, nxc, nyc), tdt)

        # rhs (assembled once: L is cheap and static) + set_bc values
        vdev = mpc_r.device if mpc_r is not None else dev
        b = assemble_vector(L, mpc, dtype=dtype, device=vdev)
        b = apply_lifting(b, [a], [bcs], mpc, dtype=dtype, device=vdev)
        b = set_bc(b, bcs)
        b_grid = b.detach().cpu().numpy().reshape(nx + 1, n1, n2, bs)
        self._b_sh = as_t(self._to_box(b_grid, mx, my, nxc, nyc), tdt)

        # ---- side matrix (slave cells + slave diagonal) ------------------
        sc = np.flatnonzero(tr.slave_cell_mask)
        slaves_row = (np.asarray(mpc_r.slaves, np.int64) if (mpc_r is not None and mpc_r.num_local_slaves)
                      else np.zeros(0, np.int64))
        batches, masks_ = [], []
        if len(sc):
            er = tr.ext_dofs
            rr = np.broadcast_to(er[:, :, None], (len(sc), er.shape[1], er.shape[1]))
            cc = np.broadcast_to(er[:, None, :], rr.shape)
            batches.append((rr, cc))
            masks_.append((rr >= 0) & (cc >= 0))
        else:
            batches.append((np.zeros((0, 1, 1), np.int64), np.zeros((0, 1, 1), np.int64)))
            masks_.append(None)
        batches.append((slaves_row, slaves_row))
        masks_.append(None)
        pattern = build_slot_pattern((V.num_dofs, V.num_dofs), batches, masks_)
        self.pattern = pattern
        nnz_side = pattern.nnz
        self.nnz_side = nnz_side

        # this box's slave cells (each cell on the box that owns it)
        cell_x = sc // (ny * nzc * T)
        cell_y = (sc // (nzc * T)) % ny
        mine = np.flatnonzero((np.minimum(cell_x // nxc, Dx - 1) == mx) & (np.minimum(cell_y // nyc, Dy - 1) == my))
        n_mine = len(mine)
        Wd = tr.T.shape[2] if tr.T.size else 1
        m_sc = max(n_mine, 1)
        Tr_sh = np.zeros((m_sc, nd, Wd), dtype)
        sc_pos = np.zeros(m_sc, np.int64)  # cell position in the local box
        sc_valid = np.zeros(m_sc, rdt)
        slot_sh = np.full(m_sc * Wd * Wd, nnz_side, np.int64)
        if n_mine:
            slots0 = pattern.slots[0].reshape(len(sc), Wd, Wd)
            c = sc[mine]
            sc_pos[:n_mine] = ((cell_x[mine] - i0) * nyc + (cell_y[mine] - j0)) * nzc * T + c % (nzc * T)
            sc_valid[:n_mine] = 1.0
            Tr_sh[:n_mine] = tr.T[mine]
            slot_sh[:n_mine * Wd * Wd] = slots0[mine].reshape(-1)
        self._Tr_sh = as_t(Tr_sh, tdt)
        self._sc_pos = as_t(sc_pos)
        self._sc_valid = as_t(sc_valid, trdt)
        self._slot_sh = as_t(slot_sh)
        # slave diagonal slots contributed once (rank (0, 0))
        self._slave_diag_slots = as_t(pattern.slots[1])

        # needed columns of the side matvec + row routing: each needed
        # global column maps to its local flat index on every box holding
        # it, weight 1 on the unique (left-in-both-axes) owner only
        need_cols = np.unique(pattern.indices)
        colpos = np.searchsorted(need_cols, pattern.indices)
        self.n_need = len(need_cols)
        gx = need_cols // (n1 * n2 * bs)
        gy = (need_cols // (n2 * bs)) % n1
        rem = need_cols % (n2 * bs)
        x0, y0 = mx * nxc, my * nyc
        ox_lo = x0 if mx == 0 else x0 + 1  # plane x0 counted by the left owner
        oy_lo = y0 if my == 0 else y0 + 1
        selx = (gx >= ox_lo) & (gx <= min((mx + 1) * nxc, nx))
        sely = (gy >= oy_lo) & (gy <= min((my + 1) * nyc, ny))
        have = (gx >= x0) & (gx <= min((mx + 1) * nxc, nx)) & (gy >= y0) & (gy <= min((my + 1) * nyc, ny))
        need_idx = np.zeros(self.n_need, np.int64)
        need_idx[have] = (gx[have] - x0) * (nyc + 1) * n2 * bs + (gy[have] - y0) * n2 * bs + rem[have]
        self._need_idx = as_t(need_idx)
        self._need_w = as_t((selx & sely).astype(rdt), trdt)

        # side rows of this box (duplicated-plane rows on ALL owners)
        srows = pattern.row_ids.astype(np.int64)
        sx = srows // (n1 * n2 * bs)
        sy = (srows // (n2 * bs)) % n1
        srem = srows % (n2 * bs)
        sel = np.flatnonzero((sx >= x0) & (sx <= min((mx + 1) * nxc, nx)) & (sy >= y0)
                             & (sy <= min((my + 1) * nyc, ny)))
        self._side_sel = as_t(sel)
        self._side_lrow = as_t((sx[sel] - x0) * (nyc + 1) * n2 * bs + (sy[sel] - y0) * n2 * bs + srem[sel])
        self._side_colp = as_t(colpos[sel])
        # diagonal side entries (row == col) join the Jacobi/Chebyshev
        # diagonal: the MPC folds master-master stiffness into the side
        self._side_diag_w = as_t((pattern.row_ids == pattern.indices)[sel].astype(rdt), trdt)

        # plane weights for dots: a shared plane counts on the LEFT owner in
        # each axis; per vertex the outer product (corners count once)
        wx = _axis_weights(Dx, nxc, nx, rdt)
        wy = _axis_weights(Dy, nyc, ny, rdt)
        self._wpq = as_t(np.outer(wx[mx], wy[my]), trdt)

        # ---- two-level GMG transfer tables (pc_type == "gmg", Dy == 1) ----
        self._gmg_tabs = None
        if pc_type == "gmg":
            # free-dof slab mask: corrections and residuals are projected
            # onto the unconstrained subspace around the coarse transfer
            free = np.ones(V.num_dofs, rdt)
            free[bc_dofs] = 0.0
            if mpc_r is not None and mpc_r.num_local_slaves:
                free[np.asarray(mpc_r.slaves)] = 0.0
            self._free_sh = as_t(self._to_box(free.reshape(nx + 1, n1, n2, bs), mx, my, nxc, nyc), trdt)
            tabs = _transfer_tables(mx, nxc, nx, wx[mx], rdt)
            self._gmg_tabs = tuple(as_t(t, trdt if t.dtype.kind == "f" else torch.int64) for t in tabs)

        # ---- sharded MIDDLE level (sharded_levels == 2) -------------------
        # the (n/2) operator is coarse_gmg.ops[0]; its data, inverse
        # diagonal and free mask are sliced into x-slabs with duplicated
        # boundary planes.  Its rows are COMPLETE on every owner, so slab
        # smoothing only needs the one-plane matvec halo.
        self.coarse_gmg_sub = None
        self._mid = None
        if pc_type == "gmg" and self.sharded_levels == 2:
            cg = coarse_gmg
            if len(cg.ops) < 2 or cg.blocked_io:
                raise ValueError("sharded_levels=2 needs >= 2 coarse levels on flat vectors")
            if nx % Dx or nxc % 2:
                raise ValueError("sharded_levels=2 needs nx % (2*Dx) == 0 (the fold plane must be the LAST "
                                 "rank's last local plane, no padding)")
            mid_op = cg.ops[0]
            if not isinstance(mid_op.dia, DIAMatrix) or mid_op._unassembled() or (
                    mid_op.side_data is not None and mid_op.side_data.shape[0] != 0):
                raise ValueError("sharded middle level must be lean (fold or interior only)")
            if mid_op.fold_axis not in (None, 0):
                raise ValueError("sharded middle level: fold along the sharded x axis only")
            nm0, nm1, nm2 = mid_op.dia.vshape
            q0 = cg.ops[1].dia.vshape
            if q0 != tuple((s - 1) // 2 + 1 for s in mid_op.dia.vshape):
                raise ValueError(f"level-1 grid {q0} is not a 2:1 coarsening of {mid_op.dia.vshape}")
            if mid_op.dia.bs != bs:
                raise ValueError("middle level block size differs from the fine level's")
            nxc2 = nxc // 2
            self._nxc2 = nxc2
            self._mid_offsets = tuple(mid_op.dia.offsets)
            self._mid_has_fold = mid_op.fold_axis is not None
            mdia = mid_op.dia.data.detach().cpu().numpy()  # (n_off2, bs, bs, nm0, nm1, nm2)
            mdiag = mid_op.diagonal().detach().cpu().numpy().reshape(nm0, nm1, nm2, bs)
            minv = np.where(mdiag != 0, 1.0 / np.where(mdiag != 0, mdiag, 1), 0.0)
            mfree = (cg.free_masks[0].detach().cpu().numpy().reshape(nm0, nm1, nm2, bs)
                     if cg.free_masks is not None else np.ones((nm0, nm1, nm2, bs), rdt))
            xa, xb = mx * nxc2, min(mx * nxc2 + nxc2 + 1, nm0)
            m_data = np.zeros(mdia.shape[:3] + (nxc2 + 3, nm1, nm2), mdia.dtype)  # halo-extended slab
            m_data[:, :, :, 1:1 + xb - xa] = mdia[:, :, :, xa:xb]
            m_inv = np.zeros((nxc2 + 1, nm1, nm2, bs), minv.dtype)
            m_inv[: xb - xa] = minv[xa:xb]
            m_free = np.zeros((nxc2 + 1, nm1, nm2, bs), rdt)
            m_free[: xb - xa] = mfree[xa:xb]
            fm = (mid_op.fold_mask.detach().cpu().numpy().reshape(nm1, nm2, bs) if self._mid_has_fold
                  else np.zeros((nm1, nm2, bs), bool))
            # the middle level's diagval in the operator's dtype (the JAX
            # package keeps only its real part, lattice_spmd.py:485)
            self._mid_dv = _scalar(mid_op.diagval, torch_dtype(dtype))
            self._mid_omega = float(cg.omegas[0])
            nq0 = (nm0 - 1) // 2 + 1
            wx2 = _axis_weights(Dx, nxc2, nm0 - 1, rdt)
            tabs2 = _transfer_tables(mx, nxc2, nm0 - 1, wx2[mx], rdt)
            self._nq0 = nq0
            mdata_t = as_t(m_data, torch_dtype(mdia.dtype))
            self._mid = {
                "dia": DIAMatrix(mdata_t, self._mid_offsets, (nxc2 + 3, nm1, nm2), bs),
                "inv": as_t(m_inv, torch_dtype(minv.dtype)), "free": as_t(m_free, trdt),
                "fm": as_t(fm, torch.bool),
                "tabs": tuple(as_t(t, trdt if t.dtype.kind == "f" else torch.int64) for t in tabs2),
            }
            # the replicated tail: the hierarchy from (n/4) down
            self.coarse_gmg_sub = cg.tail(1)

        # backsubstitution tables
        if mpc_r is not None and mpc_r.num_local_slaves:
            self._bs_tabs = (np.asarray(mpc_r.slaves, np.int64), mpc_r._np_masters.astype(np.int64),
                             mpc_r._np_coeffs.astype(dtype))
        else:
            self._bs_tabs = None
        self._dims = (nx, ny, nzc, n1, n2)

    @staticmethod
    def _to_box(grid, dx, dy, nxc, nyc):
        """(n0, n1, n2, bs) -> box (dx, dy)'s (nxc+1, nyc+1, n2, bs) planes,
        duplicated boundary planes included, zero past the global extent."""
        n0, n1 = grid.shape[0], grid.shape[1]
        out = np.zeros((nxc + 1, nyc + 1) + grid.shape[2:], grid.dtype)
        x0, y0 = dx * nxc, dy * nyc
        x1, y1 = min(x0 + nxc + 1, n0), min(y0 + nyc + 1, n1)
        if x1 > x0 and y1 > y0:
            out[: x1 - x0, : y1 - y0] = grid[x0:x1, y0:y1]
        return out

    # ------------------------------------------------------------------
    def _assemble(self):
        """This box's stencil on the halo-extended box (a DIAMatrix) and the
        side matrix (replicated)."""
        comm = self.device_mesh
        Dx, Dy, nxc, nyc, bs, T = self.Dx, self.Dy, self.nxc, self.nyc, self.bs, self.T
        nx, ny, nzc, n1, n2 = self._dims
        tdt = torch_dtype(self.dtype)
        Ae = None
        for kern, wl_t in zip(self.kernels, self._wl_sh):
            Ae_t = kern(self._coords_sh, wl_t)  # (nd, nd, c_loc)
            Ae = Ae_t if Ae is None else Ae + Ae_t
        Ae = Ae.to(tdt)
        keep = self._keep_sh
        Ae_bc = Ae * keep[:, None, :] * keep[None, :, :]
        nd = Ae.shape[0]
        Ae_grid = (Ae_bc * self._w_cell).reshape(nd, nd, nxc, nyc, nzc, T)
        ny_e = nyc + 3 if Dy > 1 else nyc + 1
        data_ext = torch.zeros((len(self.offsets), bs, bs, nxc + 3, ny_e, n2), dtype=tdt, device=self.device)
        ys = slice(1, nyc + 2) if Dy > 1 else slice(None)
        data = data_ext[:, :, :, 1:nxc + 2, ys]
        for oid, (di, dj, dk), t, a_, b_ in self._groups:
            for ci in range(bs):
                for cj in range(bs):
                    data[oid, ci, cj, di:di + nxc, dj:dj + nyc, dk:dk + nzc] += \
                        Ae_grid[a_ * bs + ci, b_ * bs + cj, :, :, :, t].sum(0)
        # dimension-ordered duplicated-plane sum: x first, then y over the
        # x-completed planes (corners complete on their own)
        lo, hi = self._exchange_axis(data[:, :, :, 0], data[:, :, :, nxc], "sx")
        data[:, :, :, 0] = lo
        data[:, :, :, nxc] = hi
        if Dy > 1:
            lo, hi = self._exchange_axis(data[:, :, :, :, 0], data[:, :, :, :, nyc], "sy")
            data[:, :, :, :, 0] = lo
            data[:, :, :, :, nyc] = hi
        zid = self.offsets.index((0, 0, 0))
        for ci in range(bs):
            data[zid, ci, ci] += self._diag_sh[:, :, :, ci]

        # side matrix: replicated by one all-reduce over both axes
        if self.nnz_side:
            Ae_sl = Ae_bc[:, :, self._sc_pos].permute(2, 0, 1) * self._sc_valid[:, None, None]
            Aep = torch.einsum("ciw,cij,cjv->cwv", torch.conj(self._Tr_sh), Ae_sl, self._Tr_sh)
            on0 = 1.0 if comm.rank == 0 else 0.0
            vals = torch.cat([Aep.reshape(-1), torch.full(self._slave_diag_slots.shape, _scalar(self.diagval, tdt)
                                                          * on0, dtype=tdt, device=self.device)])
            slots = torch.cat([self._slot_sh, self._slave_diag_slots])
            side = torch.zeros(self.nnz_side + 1, dtype=tdt, device=self.device).index_add_(0, slots, vals)
            side = comm.psum(side[:self.nnz_side])
        else:
            side = torch.zeros(0, dtype=tdt, device=self.device)
        return DIAMatrix(data_ext, self.offsets, (nxc + 3, ny_e, n2), bs), data, side

    def _exchange_axis(self, lo_partial, hi_partial, axis):
        """Sum duplicated-plane partials with both neighbours along ONE rank
        axis: lo_partial is this rank's partial of its FIRST plane (shared
        with the left neighbour's last), hi_partial of its LAST plane.
        Returns the completed (lo, hi)."""
        comm = self.device_mesh
        from_left, from_right = comm.exchange([(hi_partial, comm.ring(axis, 1)), (lo_partial, comm.ring(axis, -1))],
                                              axis)
        me, last = comm.axis_index(axis), comm.axis_size(axis) - 1
        lo = lo_partial + (from_left if me > 0 else 0.0)
        hi = hi_partial + (from_right if me < last else 0.0)
        return lo, hi

    def _halo(self, x, n_last, axis, dim):
        """x with one halo plane on each side along `dim`: the neighbours'
        planes n_last - 1 (from the left) and 1 (from the right)."""
        comm = self.device_mesh
        left, right = comm.exchange([(x.select(dim, n_last - 1), comm.ring(axis, 1)),
                                     (x.select(dim, 1), comm.ring(axis, -1))], axis)
        return torch.cat([left.unsqueeze(dim), x, right.unsqueeze(dim)], dim=dim)

    # ------------------------------------------------------------------
    def solve(self):
        """Returns (u (num_dofs,) on the rank's device, cg_iterations,
        residual_norm); every rank gets the whole u."""
        comm = self.device_mesh
        nxc, nyc, Dy = self.nxc, self.nyc, self.Dy
        lx = self.Dx - 1
        t0 = time.perf_counter()
        c0, n0_ = comm.comm_s, comm.calls
        dia, data, side = self._assemble()
        ys = slice(1, nyc + 2) if Dy > 1 else slice(None)
        side_sel, side_lrow, side_colp = self._side_sel, self._side_lrow, self._side_colp
        nnz_side = self.nnz_side
        wpq = self._wpq[:, :, None, None]
        side_rows = side[side_sel] if nnz_side else None

        def matvec(x):  # x: (nxc+1, nyc+1, n2, bs)
            xext = self._halo(x, nxc, "sx", 0)
            if Dy > 1:
                xext = self._halo(xext, nyc, "sy", 1)
            y = dia.matvec(xext.reshape(-1)).reshape(xext.shape)[1:nxc + 2, ys].contiguous()
            if nnz_side:
                # side part: gather the needed x, add this box's rows (all
                # owners of duplicated planes: consistent)
                need_x = comm.psum(self._need_w * x.reshape(-1)[self._need_idx])
                y.view(-1).index_add_(0, side_lrow, side_rows * need_x[side_colp])
            return y

        def dot(u, v):
            return comm.psum(torch.sum(wpq * torch.conj(u) * v))

        def dot2(u1, v1, u2, v2):
            s = comm.psum(torch.stack([torch.sum(wpq * torch.conj(u1) * v1), torch.sum(wpq * torch.conj(u2) * v2)]))
            return s[0], s[1]

        # Jacobi diagonal: stencil + bc diagonal PLUS the side-matrix
        # diagonal (MPC master-master terms; slave rows get diagval)
        zoff = self.offsets.index((0, 0, 0))
        diag = torch.diagonal(data[zoff], dim1=0, dim2=1).clone(memory_format=torch.contiguous_format)
        if nnz_side:
            diag.view(-1).index_add_(0, side_lrow, side_rows * self._side_diag_w)
        inv = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag)),
                          torch.zeros_like(diag))

        if self.pc_type == "chebyshev":
            M = self._chebyshev(data, diag, inv, matvec)
        elif self.pc_type == "gmg":
            M = self._gmg(inv, matvec)
        else:
            def M(r):
                return inv * r

        b = self._b_sh
        t1 = time.perf_counter()
        c1, n1_ = comm.comm_s, comm.calls
        x = torch.zeros_like(b)
        r = b - matvec(x)
        z = M(r)
        p = z
        rz, rr = dot2(r, z, r, r)
        tol2 = self.rtol ** 2 * float(dot(b, b).real)
        k = 0
        while float(rr.real) > tol2 and k < self.max_it:
            Ap = matvec(p)
            alpha = rz / dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(r)
            rzn, rr = dot2(r, z, r, r)
            p = z + (rzn / rz) * p
            rz = rzn
            k += 1
        rnorm = float(torch.sqrt(rr.real))
        t2 = time.perf_counter()
        c2, n2_ = comm.comm_s, comm.calls
        u = self._stitch(comm.all_gather(x.reshape(1, -1)))
        self.its, self.rnorm = k, rnorm
        self.times = dict(setup_s=t1 - t0, setup_comm_s=c1 - c0, solve_s=t2 - t1, comm_s=c2 - c1,
                          comm_calls=n2_ - n1_, setup_calls=n1_ - n0_)
        return u, self.its, self.rnorm

    def _stitch(self, xs):
        """The ranks' boxes (world, box values) -> the global solution, with
        the backsubstitution, on this rank's device.  Rank (dx, dy) owns
        planes [dx*nxc, dx*nxc + nxc) x [dy*nyc, dy*nyc + nyc) plus the
        global last plane of each axis."""
        n0, n1, n2 = self.vshape
        xs = xs.detach().cpu().numpy().reshape(self.Dx, self.Dy, self.nxc + 1, self.nyc + 1, n2, self.bs)

        def owner(n, nc, D):
            p = np.arange(n)
            d = np.minimum(p // nc, D - 1)
            lp = p - d * nc
            back = lp > nc  # beyond the last rank's box: walk back
            d = np.where(back, (p - 1) // nc, d)
            return d, p - d * nc

        dxs, lps = owner(n0, self.nxc, self.Dx)
        dys, lqs = owner(n1, self.nyc, self.Dy)
        u = xs[dxs[:, None], dys[None, :], lps[:, None], lqs[None, :]].reshape(-1)
        if self._bs_tabs is not None:
            sl, ma, co = self._bs_tabs
            u[sl] = np.einsum("sm,sm->s", co, u[ma])
        return torch.as_tensor(u, device=self.device)

    # ------------------------------------------------------------------
    def _chebyshev(self, data, diag, inv, matvec):
        """Chebyshev-Jacobi of degree cheb_degree on [0.06, 1] x lmax, lmax
        of D^-1 A by the GERSHGORIN bound max_i sum_j |a_ij| / d_i: a safe,
        deterministic over-estimate from one pass over the local DIA data and
        a max all-reduce (power iteration under-estimates at scale, and the
        polynomial then amplifies the untargeted top modes)."""
        comm = self.device_mesh
        rowsum = torch.abs(data).sum(dim=(0, 2))  # (bs, nxc+1, nyc+1, n2)
        dpos = torch.movedim(torch.abs(diag), -1, 0)
        ratio = torch.where(dpos > 0, rowsum / torch.clamp(dpos, min=1e-30), torch.zeros_like(rowsum))
        lmax = float(comm.pmax(torch.max(ratio))) * 1.05
        return ChebyshevPC(lambda v: inv * matvec(v), inv, lmax, 0.06, self.cheb_degree)

    def _restrict_x(self, res, n_loc):
        """Local y, z full weighting, then x full weighting with one halo
        plane per side: the COMPLETE restricted value at every local fine
        plane (R = P^T, x2 per axis)."""
        comm = self.device_mesh
        g = 2.0 * _restrict1(res, 1)
        g = 2.0 * _restrict1(g, 2)
        left, right = comm.exchange([(g[n_loc - 1], comm.ring("sx", 1)), (g[1], comm.ring("sx", -1))], "sx")
        me, last = comm.axis_index("sx"), comm.axis_size("sx") - 1
        gext = torch.cat([(left if me > 0 else torch.zeros_like(left))[None], g,
                          (right if me < last else torch.zeros_like(right))[None]], 0)
        return 2.0 * (0.5 * gext[1:-1] + 0.25 * (gext[:-2] + gext[2:]))

    def _to_replicated(self, gx, tabs, n_c, cmask, cgmg):
        """Scatter the restricted slab planes gx into the replicated coarse
        grid (one all-reduce), run the replicated hierarchy cgmg on it, and
        gather the correction back onto the slab's planes, then y, z
        prolongation."""
        r_idx, r_w, p_lo, p_hi, p_wlo, p_whi = tabs
        rc = torch.zeros((n_c,) + tuple(gx.shape[1:]), dtype=gx.dtype, device=gx.device)
        rc.index_add_(0, r_idx, r_w[:, None, None, None] * gx)
        rc = self.device_mesh.psum(rc)
        rcf = rc.reshape(-1)
        if cmask is not None:
            rcf = rcf * cmask
        ec = cgmg(rcf)
        if cmask is not None:
            ec = ec * cmask
        ecg = ec.reshape(rc.shape)
        ef = p_wlo[:, None, None, None] * ecg[p_lo] + p_whi[:, None, None, None] * ecg[p_hi]
        return _prolong1(_prolong1(ef, 1), 2)

    def _gmg(self, inv, matvec):
        """The sharded V-cycle: M2 (two levels: slab-smoothed fine level,
        replicated (n/2)-rooted hierarchy) or, at sharded_levels=2, M3 (the
        (n/2) middle level sharded in x-slabs too, the (n/4)-rooted tail
        replicated).  The reference's analogue: BoomerAMG applied
        rank-parallel inside every KSP iteration."""
        comm = self.device_mesh
        nxc = self.nxc
        lx = self.Dx - 1
        me = comm.axis_index("sx")
        omega, pre, post = self.gmg_omega, self.gmg_pre, self.gmg_post
        free = self._free_sh
        nx = self.vshape[0] - 1

        def smooth(x0, r0, n_sweeps):
            x = x0
            for _ in range(n_sweeps):
                x = x + omega * inv * (r0 - matvec(x))
            return x

        if self.sharded_levels == 1:
            cgmg = self.coarse_gmg
            cmask0 = cgmg.free_masks[0] if cgmg.free_masks is not None else None

            def M2(r):
                x0 = smooth(torch.zeros_like(r), r, pre)
                res = (r - matvec(x0)) * free
                gx = self._restrict_x(res, nxc)
                x1 = x0 + self._to_replicated(gx, self._gmg_tabs, nx // 2 + 1, cmask0, cgmg) * free
                return smooth(x1, r, post)

            return M2

        mid = self._mid
        nxc2 = self._nxc2
        mdia, minv, free_m, fmb = mid["dia"], mid["inv"], mid["free"], mid["fm"]
        mid_dv, mid_omega = self._mid_dv, self._mid_omega
        cgmg = self.coarse_gmg_sub
        qmask = cgmg.free_masks[0] if cgmg.free_masks is not None else None
        has_fold = self._mid_has_fold

        def matvec_mid(xm):
            """Slab matvec of the (n/2) middle operator: its DIA rows are
            complete on every owner, so only the one-plane x halo plus —
            for the periodic fold — two single-plane messages between the
            end ranks are exchanged."""
            u = xm
            if has_fold:
                # u = K x: rank 0's first plane overwrites the slave plane
                # (global nm0 - 1, on the LAST rank)
                first = comm.ppermute(xm[0], "sx", [(0, lx)])
                if me == lx:
                    u = xm.clone()
                    u[nxc2] = torch.where(fmb, first, xm[nxc2])
            uext = self._halo(u, nxc2, "sx", 0)
            y = mdia.matvec(uext.reshape(-1)).reshape(uext.shape)[1:nxc2 + 2].contiguous()
            if has_fold:
                # y = K^T (A u): the slave-plane row folds back onto the
                # master plane, slave rows get diagval * x
                fold_add = comm.ppermute(y[nxc2], "sx", [(lx, 0)])
                if me == 0:
                    y[0] += torch.where(fmb, fold_add, torch.zeros_like(fold_add))
                if me == lx:
                    y[nxc2] = torch.where(fmb, mid_dv * xm[nxc2], y[nxc2])
            return y

        def smooth_mid(x0, r0, n_sweeps):
            x = x0
            for _ in range(n_sweeps):
                x = x + mid_omega * minv * (r0 - matvec_mid(x))
            return x

        def M3(r):
            """Three levels: fine slab -> SHARDED (n/2) slab -> replicated
            (n/4)-rooted tail.  The fine -> middle transfer is slab-local:
            nxc is even, so every even global plane's restricted value sits
            at an even local index."""
            x0 = smooth(torch.zeros_like(r), r, pre)
            res = (r - matvec(x0)) * free
            rcs = self._restrict_x(res, nxc)[::2] * free_m  # (nxc2+1, nm1, nm2, bs)
            e1 = smooth_mid(torch.zeros_like(rcs), rcs, pre)
            res1 = (rcs - matvec_mid(e1)) * free_m
            gx2 = self._restrict_x(res1, nxc2)
            e1 = e1 + self._to_replicated(gx2, mid["tabs"], self._nq0, qmask, cgmg) * free_m
            e1 = smooth_mid(e1, rcs, post)
            # middle slab -> fine slab: slab-local x interleave
            ef = torch.zeros((nxc + 1,) + tuple(e1.shape[1:]), dtype=r.dtype, device=r.device)
            ef[::2] = e1
            ef[1::2] = 0.5 * (e1[:-1] + e1[1:])
            x1 = x0 + _prolong1(_prolong1(ef, 1), 2) * free
            return smooth(x1, r, post)

        return M3

    # ------------------------------------------------------------------
    def memory_report(self):
        """Per-rank footprint of the sharded solve, in bytes.

        `sharded_per_device` covers this rank's box tables (stencil and
        side tables, coefficients, vectors, the transfer and middle-level
        slabs) plus the stencil data the solve assembles and the CG working
        set; it weak-scales with the box size.  `replicated_coarse` is the
        coarse hierarchy every rank holds whole (the (n/4)-rooted tail at
        sharded_levels=2): it does not weak-scale.  `solver_vectors_per_device`
        is the CG working set (x, r, z, p, Ap: 5 box-sized vectors).  An
        estimate of the peak, not a measurement: temporaries add a further
        O(one box) term."""
        sharded = (self._coords_sh, self._w_cell, self._keep_sh, self._diag_sh, self._b_sh, self._Tr_sh,
                   self._sc_pos, self._sc_valid, self._slot_sh, self._need_idx, self._need_w, self._side_sel,
                   self._side_lrow, self._side_colp, self._side_diag_w, self._wpq, self._wl_sh,
                   getattr(self, "_free_sh", None), self._gmg_tabs,
                   None if self._mid is None else {k: v for k, v in self._mid.items() if k != "dia"})
        rep_h = self.coarse_gmg_sub if self.sharded_levels == 2 else self.coarse_gmg
        rep = _tensor_bytes(rep_h) if rep_h is not None else 0
        n_off = len(self.offsets)
        n2 = self.vshape[2]
        ny_e = self.nyc + 3 if self.Dy > 1 else self.nyc + 1
        item = np.dtype(self.dtype).itemsize
        data_b = n_off * self.bs * self.bs * (self.nxc + 3) * ny_e * n2 * item
        if self._mid is not None:
            data_b += self._mid["dia"].data.numel() * self._mid["dia"].data.element_size()
        solver_b = 5 * self._b_sh.numel() * self._b_sh.element_size()
        return {
            "n_devices": self.Dx * self.Dy,
            "sharded_per_device": _tensor_bytes(sharded) + data_b + solver_b,
            "replicated_coarse": rep,
            "stencil_data_per_device": data_b,
            "solver_vectors_per_device": solver_b,
        }
