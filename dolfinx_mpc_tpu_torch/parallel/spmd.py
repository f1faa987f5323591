"""Distributed general path: cell-sharded constrained assembly + row-block
CG over the ranks of a ``torch.distributed`` group.

Counterpart of ``dolfinx_mpc_tpu/parallel/spmd.py``, whose one
``shard_map`` program becomes one process per rank (parallel/comm.py).
The reference's MPI domain decomposition (DOLFINx IndexMap owner/ghost
tables, PETSc's off-process value caching) becomes static host tables —
numpy, the JAX package's own code, equal to its tables bit for bit — and
three collectives:

- assembly: every rank computes the element tensors of its cell shard with
  a uniform per-cell prolongation T (identity for unconstrained cells),
  ``conj(T)^T A_e T``, adds them into the GLOBAL packed CSR-slot layout, and
  one reduce-scatter leaves it with exactly its row block of matrix data;
  the right-hand side likewise;
- solve: CG with the matrix and every Krylov vector row-block distributed.
  Each rank holds its rpd rows plus the ghost values its columns reference;
  the halo exchange is one batch of point-to-point messages, one ring
  offset per active offset with its own buffer width (the IndexMap
  scatter_fwd analogue), and the row block's product on that window is one
  CSR SpMV: kernel K8 (la/bell.py:bell_matvec) on the block's nonzeros,
  held as a ``BellPacked``, on the card; its plain version on the CPU;
- the solution is all-gathered once at the end for the backsubstitution.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .._dtypes import torch_dtype
from ..fem.forms import Form
from ..la.bell import BellPacked, bell_matvec
from ..la.sparse import build_slot_pattern
from ..multipointconstraint import MultiPointConstraint
from ..ops.assemble import CellTransforms, _bc_masks, _bc_values, _build_cell_transforms, _mpc_pair, _real_dtype
from ..ops.kernels import compile_term
from .comm import RankGrid

__all__ = ["ShardedLinearProblem", "make_device_mesh"]


def make_device_mesh(shape=None, device="cuda") -> RankGrid:
    """This rank's RankGrid over the initialized process group: (world, 1)
    x-slabs by default, or the (Dx, Dy) `shape`; tensors on `device`."""
    return RankGrid(shape, device)


def _ext_uniform(tr: CellTransforms, pos: np.ndarray, dm: np.ndarray) -> np.ndarray:
    """ext dof table for EVERY cell: plain dofs for unconstrained cells,
    the slave-cell extended row otherwise.  Vectorized (no per-cell loop)."""
    n, nd = dm.shape
    We = tr.ext_dofs.shape[1] if tr.ext_dofs.size else nd
    W = max(We, nd)
    out = np.full((n, W), -1, dtype=np.int64)
    out[:, :nd] = dm
    hit = pos >= 0
    if hit.any():
        sub = np.full((int(hit.sum()), W), -1, dtype=np.int64)
        sub[:, :We] = tr.ext_dofs[pos[hit]]
        out[hit] = sub
    return out


def _T_uniform(tr: CellTransforms, pos: np.ndarray, nd: int, W: int, dtype) -> np.ndarray:
    n = len(pos)
    out = np.zeros((n, nd, W), dtype=dtype)
    out[:, :, :nd] = np.eye(nd, dtype=dtype)
    hit = pos >= 0
    if hit.any():
        Wt = tr.T.shape[2]
        sub = np.zeros((int(hit.sum()), nd, W), dtype=dtype)
        sub[:, :, :Wt] = tr.T[pos[hit]]
        out[hit] = sub
    return out


def _pad_cells(arr: np.ndarray, n_pad: int, fill="repeat"):
    """Pad the leading (cell) axis to n_pad; `repeat` duplicates row 0 (keeps
    geometry non-degenerate), otherwise fills with the given constant."""
    n = arr.shape[0]
    if n == n_pad:
        return arr
    pad_shape = (n_pad - n,) + arr.shape[1:]
    if fill == "repeat":
        pad = np.broadcast_to(arr[:1], pad_shape).copy() if n else np.zeros(pad_shape, arr.dtype)
    else:
        pad = np.full(pad_shape, fill, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


@dataclass
class RowPartition:
    """Row-block partition of a SlotPattern across n_dev ranks.

    Packed layout: entry j of rank d lives at global packed slot
    d*nnz_pad + (j - indptr[row_start_d]); CSR entries are row-sorted so each
    rank's rows are a contiguous slot range.
    """

    n_dev: int
    rows_per_dev: int  # rpd; rank d owns rows [d*rpd, (d+1)*rpd)
    nnz_pad: int
    remap: np.ndarray  # (nnz+1,) old slot -> packed slot (trash -> n_dev*nnz_pad)
    cols: np.ndarray  # (n_dev, nnz_pad) int32, 0-padded
    lrows: np.ndarray  # (n_dev, nnz_pad) int32 local row, 0-padded
    valid: np.ndarray  # (n_dev, nnz_pad) bool


def build_ghost_exchange(part: RowPartition):
    """Static halo-exchange tables for the distributed SpMV.

    For each rank d, the off-block columns of its rows are its GHOSTS.
    Ghost traffic is organized by ring OFFSET delta = (dst - src) mod n_dev
    — one rotation per ACTIVE offset, each with its own buffer width.  With
    row-block partitions of a locality-ordered mesh, only delta = +-1 (slab
    neighbors) and the few offsets induced by MPC couplings (periodic wrap,
    contact interface) are active, so the receive window is
    rpd + sum_active(ms_delta).

    Returns:
      rounds: list of (delta, send_idx) with send_idx (n_dev, ms_delta)
        int32 — rank s sends x_loc[send_idx[s]] to (s+delta) % n_dev;
      lcols: (n_dev, nnz_pad) int32 — per-nnz LOCAL column: owned columns
        map to [0, rpd), ghosts to rpd + offset_of(delta) + j;
      window: rpd + total ghost slots (per-rank vector length).
    """
    n_dev, rpd = part.n_dev, part.rows_per_dev
    # ghosts[s][d]: global cols rank d needs from source s
    ghosts = [[np.zeros(0, np.int64)] * n_dev for _ in range(n_dev)]
    for d in range(n_dev):
        cols = part.cols[d][part.valid[d]].astype(np.int64)
        off = cols[(cols // rpd) != d]
        if off.size:
            u = np.unique(off)
            own = u // rpd
            for s in np.unique(own):
                ghosts[int(s)][d] = u[own == s]
    # active ring offsets and their buffer widths
    ms_delta = {}
    for s in range(n_dev):
        for d in range(n_dev):
            cnt = ghosts[s][d].shape[0]
            if cnt:
                delta = (d - s) % n_dev
                ms_delta[delta] = max(ms_delta.get(delta, 0), cnt)
    deltas = sorted(ms_delta)
    offsets = {}
    pos = rpd
    for delta in deltas:
        offsets[delta] = pos
        pos += ms_delta[delta]
    window = pos
    rounds = []
    for delta in deltas:
        si = np.zeros((n_dev, ms_delta[delta]), np.int32)
        for s in range(n_dev):
            g = ghosts[s][(s + delta) % n_dev]
            si[s, : g.shape[0]] = (g - s * rpd).astype(np.int32)
        rounds.append((delta, si))
    lcols = np.zeros((n_dev, part.nnz_pad), np.int32)
    for d in range(n_dev):
        gmap = {}
        for s in range(n_dev):
            g = ghosts[s][d]
            if g.size:
                base = offsets[(d - s) % n_dev]
                for j, c in enumerate(g):
                    gmap[int(c)] = base + j
        cols = part.cols[d].astype(np.int64)
        own = (cols // rpd) == d
        lc = np.where(own & part.valid[d], cols - d * rpd, 0).astype(np.int64)
        gh = np.flatnonzero(~own & part.valid[d])
        if gh.size:
            lc[gh] = np.fromiter((gmap[int(c)] for c in cols[gh]), np.int64, count=gh.size)
        lcols[d] = lc.astype(np.int32)
    return rounds, lcols, window


def partition_rows(pattern, n_dev: int) -> RowPartition:
    N = pattern.shape[0]
    rpd = -(-N // n_dev)
    nnz = pattern.nnz
    row_ids = pattern.row_ids.astype(np.int64)
    indptr = pattern.indptr
    bounds = np.minimum(np.arange(n_dev + 1) * rpd, N)
    start = indptr[bounds[:-1]]
    end = indptr[bounds[1:]]
    nnz_d = end - start
    nnz_pad = max(int(nnz_d.max()) if n_dev else 1, 1)
    dev_of = row_ids // rpd
    new_slot = dev_of * nnz_pad + (np.arange(nnz, dtype=np.int64) - start[dev_of])
    remap = np.append(new_slot, n_dev * nnz_pad).astype(np.int64)
    cols = np.zeros((n_dev, nnz_pad), dtype=np.int32)
    lrows = np.zeros((n_dev, nnz_pad), dtype=np.int32)
    valid = np.zeros((n_dev, nnz_pad), dtype=bool)
    for d in range(n_dev):
        k = nnz_d[d]
        cols[d, :k] = pattern.indices[start[d] : end[d]]
        lrows[d, :k] = row_ids[start[d] : end[d]] - d * rpd
        valid[d, :k] = True
    return RowPartition(n_dev, rpd, nnz_pad, remap, cols, lrows, valid)


class ShardedLinearProblem:
    """Distributed constrained Poisson-type solve: assemble(A, b) + lifting
    + set_bc + CG + backsubstitution, with the cells sharded over the ranks
    of `device_mesh` (a RankGrid; the world as x-slabs by default) and the
    rows of A and of every Krylov vector in row blocks (the reference's
    LinearProblem.solve end to end, problem.py:532-598).  Every rank
    constructs the problem from the same inputs and calls solve() together;
    tensors live on device_mesh.device."""

    def __init__(self, a: Form, L: Form, mpc: MultiPointConstraint, bcs=None, device_mesh: RankGrid = None,
                 dtype=np.float64, rtol=1e-8, max_it=2000, diagval=1.0):
        self.device_mesh = device_mesh if device_mesh is not None else make_device_mesh()
        comm = self.device_mesh
        if comm.shape[1] != 1:
            raise ValueError("ShardedLinearProblem: a 1-D rank grid (x-slabs) only")
        n_dev = comm.world
        self.n_dev = n_dev
        me = comm.rank
        dev = comm.device
        self.device = dev
        bcs = bcs or []
        mpc_r, mpc_c = _mpc_pair(mpc)
        self.mpc = mpc_r
        Vt, Vs = a.test_space, a.trial_space
        self.V = Vt
        dtype = np.dtype(dtype)
        self.dtype = dtype
        tr_row = _build_cell_transforms(Vt, mpc_r, dtype)
        tr_col = _build_cell_transforms(Vs, mpc_c, dtype)
        mesh = Vt.mesh
        points = mesh.points
        rdt = _real_dtype(dtype)

        # ---- host: uniform per-cell tables, sharded on the cell axis ------
        a_terms = [compile_term(t, Vt, Vs) for t in a.terms]
        L_terms = [compile_term(t, Vt, None) for t in L.terms]

        N = Vt.num_dofs
        batches, masks = [], []
        a_tabs = []
        for ct in a_terms:
            cells = ct.cells
            dmr, dmc = Vt.dofmap[cells], Vs.dofmap[cells]
            pr, pc = tr_row.cell_pos[cells], tr_col.cell_pos[cells]
            er = _ext_uniform(tr_row, pr, dmr)
            ec = _ext_uniform(tr_col, pc, dmc)
            n_act = len(cells)
            rr = np.broadcast_to(er[:, :, None], (n_act, er.shape[1], ec.shape[1]))
            cc = np.broadcast_to(ec[:, None, :], rr.shape)
            batches.append((rr, cc))
            masks.append((rr >= 0) & (cc >= 0))
            lf = ct.local_facets if ct.local_facets is not None else np.zeros(n_act, np.int32)
            a_tabs.append(dict(cells=cells, pr=pr, pc=pc, dmr=dmr, dmc=dmc, er=er, ec_w=ec.shape[1], lf=lf))
        slaves_row = (np.asarray(mpc_r.slaves, np.int64) if (mpc_r is not None and mpc_r.num_local_slaves)
                      else np.zeros(0, np.int64))
        batches.append((slaves_row, slaves_row))
        masks.append(None)
        bc_dofs = np.unique(np.concatenate([bc.dofs for bc in bcs])) if bcs else np.zeros(0, np.int64)
        batches.append((bc_dofs, bc_dofs))
        masks.append(None)

        pattern = build_slot_pattern((N, Vs.num_dofs), batches, masks)
        part = partition_rows(pattern, n_dev)
        self.pattern = pattern
        self.part = part
        rounds, lcols, self._window = build_ghost_exchange(part)
        self._deltas = tuple(d for d, _ in rounds)
        rpd = part.rows_per_dev
        N_pad = rpd * n_dev
        self.N_pad = N_pad
        TRASH = n_dev * part.nnz_pad

        def as_t(arr, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=dt, device=dev)

        tdt = torch_dtype(dtype)
        # this rank's shard of the per-term tables (cells [me*C, (me+1)*C)
        # of the padded cell axis)
        self._a_tabs = []
        for ti, tb in enumerate(a_tabs):
            cells = tb["cells"]
            n_act = len(cells)
            C = -(-n_act // n_dev)
            n_pad = C * n_dev
            mine = lambda arr, fill="repeat": _pad_cells(arr, n_pad, fill)[me * C:(me + 1) * C]  # noqa: E731
            sl = part.remap[pattern.slots[ti]].reshape(n_act, -1)
            er = tb["er"]
            tgt = np.where(er >= 0, er, N_pad)  # vector trash row
            dmr, dmc = tb["dmr"], tb["dmc"]
            Tr = _T_uniform(tr_row, mine(tb["pr"]), dmr.shape[1], er.shape[1], dtype)
            Tc = _T_uniform(tr_col, mine(tb["pc"]), dmc.shape[1], tb["ec_w"], dtype)
            # padding cells repeat cell 0's geometry and tables but carry
            # zero T, trash slots and trash targets: they add nothing
            pad = np.arange(me * C, (me + 1) * C) >= n_act
            Tr[pad] = 0
            Tc[pad] = 0
            self._a_tabs.append(dict(
                coords=as_t(mine(points[mesh.cells[cells]]), torch_dtype(rdt)),
                lf=as_t(mine(tb["lf"])),
                Tr=as_t(Tr, tdt), Tc=as_t(Tc, tdt),
                dmr=as_t(mine(dmr)), dmc=as_t(mine(dmc)),
                slots=as_t(mine(sl, TRASH).reshape(-1)),
                tgt=as_t(mine(tgt, N_pad).reshape(-1)),
                wdofmaps={n: as_t(mine(W.dofmap[cells])) for n, W in zip(a_terms[ti].coeff_names,
                                                                          a_terms[ti].coeff_spaces)}))
        self._diag_slots = (as_t(part.remap[pattern.slots[len(a_tabs)]]),
                            as_t(part.remap[pattern.slots[len(a_tabs) + 1]]))

        # rhs term tables (uniform T, cell-sharded)
        self._L_tabs = []
        for ct in L_terms:
            cells = ct.cells
            dmr = Vt.dofmap[cells]
            pr = tr_row.cell_pos[cells]
            er = _ext_uniform(tr_row, pr, dmr)
            n_act = len(cells)
            C = -(-n_act // n_dev)
            n_pad = C * n_dev
            mine = lambda arr, fill="repeat": _pad_cells(arr, n_pad, fill)[me * C:(me + 1) * C]  # noqa: E731
            Tr = _T_uniform(tr_row, mine(pr), dmr.shape[1], er.shape[1], dtype)
            Tr[np.arange(me * C, (me + 1) * C) >= n_act] = 0
            lf = ct.local_facets if ct.local_facets is not None else np.zeros(n_act, np.int32)
            self._L_tabs.append(dict(
                coords=as_t(mine(points[mesh.cells[cells]]), torch_dtype(rdt)),
                lf=as_t(mine(lf)), Tr=as_t(Tr, tdt),
                tgt=as_t(mine(np.where(er >= 0, er, N_pad), N_pad).reshape(-1)),
                wdofmaps={n: as_t(mine(W.dofmap[cells])) for n, W in zip(ct.coeff_names, ct.coeff_spaces)}))

        # bc data (replicated)
        bc_row_mask = _bc_masks(Vt, bcs, dtype)
        bc_vals = _bc_values(Vs, bcs, dtype)
        self._bc_row_mask = as_t(np.concatenate([bc_row_mask, np.zeros(N_pad - N, bc_row_mask.dtype)]), tdt)
        self._bc_vals = as_t(np.concatenate([bc_vals, np.zeros(N_pad - N, dtype)]), tdt)

        # mpc tables in the N_pad address space (replicated)
        if mpc_r is not None and mpc_r.num_local_slaves:
            self._mpc_tabs = (as_t(mpc_r.slaves), as_t(mpc_r._np_masters), as_t(mpc_r._np_coeffs, tdt))
        else:
            self._mpc_tabs = None

        # this rank's row block: its CSR (valid entries are a prefix, rows
        # sorted), local columns on the ghost window, and the ghost rounds
        k = int(part.valid[me].sum())
        self._nnz_loc = k
        counts = np.bincount(part.lrows[me, :k], minlength=rpd)
        self._row_ptr = as_t(np.concatenate([[0], np.cumsum(counts)]), torch.int32)
        self._lcols = as_t(lcols[me, :k], torch.int32)
        self._diag_pos = as_t(np.flatnonzero(part.cols[me, :k] == part.lrows[me, :k] + me * rpd))
        self._diag_rows = as_t(part.lrows[me, :k][part.cols[me, :k] == part.lrows[me, :k] + me * rpd])
        self._rounds = [(delta, as_t(si[me])) for delta, si in rounds]
        self._a_kernels = [ct.kernel for ct in a_terms]
        self._L_kernels = [ct.kernel for ct in L_terms]
        self._a_coeffs = [{n: t.term.coefficients[n].x.array.to(dev) for n in t.coeff_names} for t in a_terms]
        self._L_coeffs = [{n: t.term.coefficients[n].x.array.to(dev) for n in t.coeff_names} for t in L_terms]
        self.rtol, self.max_it, self.diagval = rtol, max_it, diagval

    # ------------------------------------------------------------------
    def _assemble(self):
        """This rank's row block of A (as K8's packed CSR) and of b."""
        comm, dev = self.device_mesh, self.device
        part, N_pad = self.part, self.N_pad
        tdt = torch_dtype(self.dtype)
        bc_row, g = self._bc_row_mask, self._bc_vals
        vals, slots = [], []
        b_part = torch.zeros(N_pad + 1, dtype=tdt, device=dev)
        for kern, tb, coeffs in zip(self._a_kernels, self._a_tabs, self._a_coeffs):
            wl = {n: coeffs[n][tb["wdofmaps"][n]] for n in coeffs}
            Ae = kern(tb["coords"], tb["lf"], wl).to(tdt)  # (C, ndt, nds)
            # lifting from the RAW tensor: be = -Ae (g masked to bc cols)
            gcell = g[tb["dmc"]] * bc_row[tb["dmc"]]
            be_l = -torch.einsum("cij,cj->ci", Ae, gcell)
            bep = torch.einsum("ciw,ci->cw", torch.conj(tb["Tr"]), be_l)
            b_part.index_add_(0, tb["tgt"], bep.reshape(-1))
            # bc row/col zeroing then uniform K^H Ae K
            mr = 1.0 - bc_row[tb["dmr"]]
            mc = 1.0 - bc_row[tb["dmc"]]
            Ae = Ae * mr[:, :, None] * mc[:, None, :]
            Aep = torch.einsum("ciw,cij,cjv->cwv", torch.conj(tb["Tr"]), Ae, tb["Tc"])
            vals.append(Aep.reshape(-1))
            slots.append(tb["slots"])
        # diagonals, contributed once (rank 0 only)
        on0 = 1.0 if comm.rank == 0 else 0.0
        for ds in self._diag_slots:
            vals.append(torch.full(ds.shape, self.diagval * on0, dtype=tdt, device=dev))
            slots.append(ds)
        partial = torch.zeros(self.n_dev * part.nnz_pad + 1, dtype=tdt, device=dev)
        partial.index_add_(0, torch.cat(slots), torch.cat(vals))
        data_d = comm.psum_scatter(partial[:-1])

        for kern, tb, coeffs in zip(self._L_kernels, self._L_tabs, self._L_coeffs):
            wl = {n: coeffs[n][tb["wdofmaps"][n]] for n in coeffs}
            be = kern(tb["coords"], tb["lf"], wl).to(tdt)
            bep = torch.einsum("ciw,ci->cw", torch.conj(tb["Tr"]), be)
            b_part.index_add_(0, tb["tgt"], bep.reshape(-1))
        # row-block RHS: one reduce-scatter, never a full replicated b
        b_loc = comm.psum_scatter(b_part[:N_pad])
        # set_bc on the local block: b[bc] = diagval * g
        rpd = part.rows_per_dev
        row0 = comm.rank * rpd
        bc_loc = bc_row[row0:row0 + rpd]
        b_loc = torch.where(bc_loc > 0, self.diagval * g[row0:row0 + rpd], b_loc)
        A_loc = BellPacked(self._row_ptr, self._lcols, data_d[:self._nnz_loc].contiguous(), (rpd, self._window))
        return A_loc, b_loc

    def solve(self):
        """Returns (u (num_dofs,) on the rank's device, cg_iterations,
        residual_norm); every rank gets the whole u."""
        comm = self.device_mesh
        rpd = self.part.rows_per_dev
        t0 = time.perf_counter()
        c0, n0 = comm.comm_s, comm.calls
        A_loc, b_loc = self._assemble()

        def exchange(x_loc):
            """ghost scatter: one ring rotation per active offset, all in
            one batch of messages."""
            got = comm.exchange([(x_loc[si], comm.ring("sx", delta)) for delta, si in self._rounds], "sx")
            return torch.cat([x_loc] + got)

        def matvec(x_loc):
            return bell_matvec(A_loc, exchange(x_loc))

        def pdot(u, v):
            return comm.psum(torch.vdot(u, v))

        def pdot2(u1, v1, u2, v2):
            s = comm.psum(torch.stack([torch.vdot(u1, v1), torch.vdot(u2, v2)]))
            return s[0], s[1]

        diag_loc = torch.zeros(rpd, dtype=b_loc.dtype, device=self.device)
        diag_loc.index_add_(0, self._diag_rows, A_loc.vals[self._diag_pos])
        inv = torch.where(diag_loc != 0, 1.0 / diag_loc, torch.zeros_like(diag_loc))
        t1 = time.perf_counter()
        c1, n1 = comm.comm_s, comm.calls

        x = torch.zeros(rpd, dtype=b_loc.dtype, device=self.device)
        r = b_loc - matvec(x)
        z = inv * r
        p = z
        rz, rr = pdot2(r, z, r, r)
        tol2 = self.rtol ** 2 * float(pdot(b_loc, b_loc).real)
        # rr rides in the loop state (reduced with r.z), so each iteration
        # costs two all-reduces: p.Ap, then [r.z, r.r]
        k = 0
        while float(rr.real) > tol2 and k < self.max_it:
            Ap = matvec(p)
            alpha = rz / pdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = inv * r
            rz_new, rr = pdot2(r, z, r, r)
            p = z + (rz_new / rz) * p
            rz = rz_new
            k += 1
        rnorm = float(torch.sqrt(rr.real))
        # gather the solution once at the end (the OUTPUT is global);
        # backsubstitution may reference remote masters
        xg = comm.all_gather(x)
        if self._mpc_tabs is not None:
            sl, ma, co = self._mpc_tabs
            xg[sl] = torch.einsum("sm,sm->s", co, xg[ma].to(co.dtype))
        t2 = time.perf_counter()
        self.its = k
        self.rnorm = rnorm
        self.times = dict(setup_s=t1 - t0, setup_comm_s=c1 - c0, solve_s=t2 - t1, comm_s=comm.comm_s - c1,
                          comm_calls=comm.calls - n1, setup_calls=n1 - n0)
        return xg[: self.V.num_dofs], self.its, self.rnorm
