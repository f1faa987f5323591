"""Lattice fast path (torch): scatter-free assembly and stencil SpMV for
structured box meshes, lean "fold" format.

Counterpart of ``dolfinx_mpc_tpu/ops/lattice.py`` for the fold path.  On a
structured box mesh the sparsity is a stencil: the (cell, a, b) -> entry map
collapses to a fixed set of lattice diagonal offsets, so the matrix is a DIA
array and SpMV is a sum of shifted products.  Degree 2 keeps the same idea
on the parity-blocked layout (``BlockDIAMatrix``): the refined grid splits
into 8 parity classes, and each (row class, column class, coarse offset)
triple holds one value per coarse box.  A periodic constraint that
identifies the last lattice plane of one axis with the first ("fold") is
applied inside the operator: u = K x copies the master plane onto the slave
plane, y = A u, the slave-plane rows fold back onto the masters (K^T), and
slave rows get diagval — K^T A K without any irregular operation.

The lean fold branch assembles from a per-plane table reduced on the host
(ops/lattice_kernels.py: build_fold_table) through kernel K1 (degree 1, any
bs <= 3) or K4 (degree 2) when the Dirichlet set is separable, through K3
when it is not, and through K5 when the form has no Dirichlet dof; every
scalar DIA matvec on the card runs kernel K2, every vector (bs > 1) one K7
and every blocked one K6.  Not ported yet, each raising NotImplementedError
with its ROADMAP item: the "csr"/"cells" side formats, x-dependent or
coefficient forms and vector spaces at degree 2 (the element-kernel lean
path) and non-uniform geometry (slice 4).
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from .._dtypes import torch_dtype
from ..fem.forms import Form
from ..fem.lattice_info import LatticeInfo, get_lattice_info
from ..multipointconstraint import MultiPointConstraint
from .assemble import _bc_masks, _mpc_pair, _real_dtype
from .lattice_kernels import (
    DiaMatvecLaunch,
    _detect_factored_masks,
    assemble_fold_lean_blocked,
    assemble_fold_lean_factored,
    assemble_fold_lean_masked,
    assemble_fold_lean_raw,
    blocked_matvec,
    blocked_trip_table,
    build_fold_table,
    dia_matvec,
    dia_matvec_bs,
    fold_kernel_supported,
)

__all__ = ["DIAMatrix", "BlockDIAMatrix", "LatticeOperator", "CompiledLatticeForm",
           "assemble_matrix_lattice"]


# ---------------------------------------------------------------------------
# DIA matrix: data per diagonal offset over the vertex lattice
# ---------------------------------------------------------------------------


class DIAMatrix:
    """Stencil matrix over an (n0, n1, n2) vertex lattice with `bs` dof
    components per vertex.

    data: (n_off, bs, bs, n0, n1, n2) — entry A[(v, ci), (v+off_d, cj)] =
    data[d, ci, cj, v].  At bs = 1 on the card the first matvec prepares
    K2's launch (DiaMatvecLaunch) and keeps it for the next ones.
    """

    def __init__(self, data, offsets, vshape, bs):
        self.data = data
        self.offsets = tuple(tuple(int(v) for v in o) for o in offsets)
        self.vshape = tuple(int(v) for v in vshape)
        self.bs = int(bs)
        self._k2 = None

    @property
    def shape(self):
        n = int(np.prod(self.vshape)) * self.bs
        return (n, n)

    def matvec(self, x):
        """K2 (bs = 1) or K7 (bs > 1) on the card, their plain version on
        the CPU."""
        if self.bs == 1:
            if self._k2 is None and self.data.device.type == "cuda":
                self._k2 = DiaMatvecLaunch(self.data, self.offsets, self.vshape)
            if self._k2 is not None:
                return self._k2(x)
            return dia_matvec(self.data, self.offsets, self.vshape, x)
        return dia_matvec_bs(self.data, self.offsets, self.vshape, self.bs, x)

    def diagonal(self):
        zid = self.offsets.index((0, 0, 0)) if (0, 0, 0) in self.offsets else None
        if zid is None:
            return torch.zeros(self.shape[0], dtype=self.data.dtype, device=self.data.device)
        # (bs, bs, n0, n1, n2) -> interleaved (n*bs,)
        return torch.diagonal(self.data[zid], dim1=0, dim2=1).reshape(-1).clone()

    def to_scipy(self):
        import scipy.sparse as sp

        n0, n1, n2 = self.vshape
        bs = self.bs
        N = n0 * n1 * n2 * bs
        rows, cols, vals = [], [], []
        data = self.data.detach().cpu().numpy()
        I, J, K = np.meshgrid(np.arange(n0), np.arange(n1), np.arange(n2), indexing="ij")
        vid = (I * n1 + J) * n2 + K
        for d, (di, dj, dk) in enumerate(self.offsets):
            m = ((I + di >= 0) & (I + di < n0) & (J + dj >= 0) & (J + dj < n1)
                 & (K + dk >= 0) & (K + dk < n2))
            r = vid[m]
            c = (((I + di) * n1 + (J + dj)) * n2 + (K + dk))[m]
            for ci in range(bs):
                for cj in range(bs):
                    rows.append(r * bs + ci)
                    cols.append(c * bs + cj)
                    vals.append(data[d, ci, cj][m])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(N, N)
        )


class BlockDIAMatrix:
    """Parity-blocked stencil matrix of an r-refined lattice (the degree-2
    fast path), scalar only.  Dofs split by their parity inside a coarse box
    into classes (vertex / edge / face / body families); each (row class,
    column class, coarse offset) triple stores one value per coarse box.

    data: (n_trip, s0, s1, s2) over the PADDED class grids,
    s = ceil(vshape / r3); trips[m] = (cls_row, cls_col, off), off in coarse
    boxes.  Padded rows and columns hold exact zeros (assembly writes zeros
    there, the x split pads with zeros), so a matvec is shifted products on
    the uniform padded grids."""

    def __init__(self, data, trips, vshape, r3, bs=1):
        if bs != 1:
            raise ValueError("the blocked stencil path is scalar-only")
        self.data = data
        self.trips = tuple((tuple(cr), tuple(cc), tuple(off)) for cr, cc, off in trips)
        self.vshape = tuple(int(v) for v in vshape)
        self.r3 = tuple(int(v) for v in r3)
        self.bs = 1
        self._tables = {}  # K6's triple table, per device

    @property
    def cdims(self):
        return tuple(-(-n // r) for n, r in zip(self.vshape, self.r3))

    @property
    def classes(self):
        return tuple(itertools.product(*(range(r) for r in self.r3)))

    @property
    def shape(self):
        n = int(np.prod(self.vshape))
        return (n, n)

    def _to_blocked(self, x):
        """fine (n0, n1, n2) flat vector -> (n_classes, s0, s1, s2) padded
        class stack (class-major split by refined parity)."""
        n0, n1, n2 = self.vshape
        r0, r1, r2 = self.r3
        s0, s1, s2 = self.cdims
        xp = torch.nn.functional.pad(x.reshape(n0, n1, n2),
                                     (0, r2 * s2 - n2, 0, r1 * s1 - n1, 0, r0 * s0 - n0))
        return (xp.reshape(s0, r0, s1, r1, s2, r2).permute(1, 3, 5, 0, 2, 4)
                .reshape(-1, s0, s1, s2))

    def _from_blocked(self, yb):
        n0, n1, n2 = self.vshape
        r0, r1, r2 = self.r3
        s0, s1, s2 = self.cdims
        yf = (yb.reshape(r0, r1, r2, s0, s1, s2).permute(3, 0, 4, 1, 5, 2)
              .reshape(r0 * s0, r1 * s1, r2 * s2))
        return yf[:n0, :n1, :n2].reshape(-1)

    def matvec(self, x):
        return self._from_blocked(self.matvec_blocked(self._to_blocked(x)))

    def matvec_blocked(self, xb):
        """SpMV on the padded blocked class stack (n_cls, s0, s1, s2), the
        solve path's layout: kernel K6 on a CUDA tensor, the plain halo-pad
        slice-FMA on a CPU one.  Padded slots stay exact zeros."""
        table = None
        if xb.device.type == "cuda":
            table = self._tables.get(xb.device)
            if table is None:
                table = torch.as_tensor(blocked_trip_table(self.trips, self.classes), device=xb.device)
                self._tables[xb.device] = table
            xb = xb.contiguous()
        return blocked_matvec(self.data, self.trips, self.classes, xb, table)

    def diagonal_blocked(self):
        """Diagonal as the padded blocked class stack (n_cls, s0, s1, s2)."""
        cls_id = {c: i for i, c in enumerate(self.classes)}
        out = torch.zeros((len(cls_id),) + self.cdims, dtype=self.data.dtype, device=self.data.device)
        for m, (cr, cc, off) in enumerate(self.trips):
            if cr == cc and off == (0, 0, 0):
                out[cls_id[cr]] = self.data[m]
        return out

    def diagonal(self):
        return self._from_blocked(self.diagonal_blocked())

    def to_scipy(self):
        import scipy.sparse as sp

        n0, n1, n2 = self.vshape
        r0, r1, r2 = self.r3
        s0, s1, s2 = self.cdims
        N = n0 * n1 * n2
        data = self.data.detach().cpu().numpy()
        Q0, Q1, Q2 = np.meshgrid(np.arange(s0), np.arange(s1), np.arange(s2), indexing="ij")
        rows, cols, vals = [], [], []
        for m, (cr, cc, off) in enumerate(self.trips):
            fi, fj, fk = r0 * Q0 + cr[0], r1 * Q1 + cr[1], r2 * Q2 + cr[2]
            gi = r0 * (Q0 + off[0]) + cc[0]
            gj = r1 * (Q1 + off[1]) + cc[1]
            gk = r2 * (Q2 + off[2]) + cc[2]
            ok = ((fi < n0) & (fj < n1) & (fk < n2) & (gi >= 0) & (gi < n0)
                  & (gj >= 0) & (gj < n1) & (gk >= 0) & (gk < n2))
            rows.append(((fi * n1 + fj) * n2 + fk)[ok])
            cols.append(((gi * n1 + gj) * n2 + gk)[ok])
            vals.append(data[m][ok])
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(N, N))


class LatticeOperator:
    """DIA (or parity-blocked) stencil with the periodic fold: K^T A K with
    the slave plane's rows and columns replaced by diagval on the diagonal.

    fold_axis: lattice axis whose last plane holds the slaves; fold_mask:
    bool (plane shape + (bs,)) marking the slaves of that plane; fold_pairs:
    host (slaves, masters) arrays, needed only by to_scipy(); fold_mask_b:
    on a BlockDIAMatrix, the blocked fold mask (n_cls, sA, sB) over the
    class grids of the two other axes, which the blocked-native
    matvec_blocked needs."""

    def __init__(self, dia, diagval, fold_axis, fold_mask, fold_pairs=None, fold_mask_b=None):
        self.dia = dia
        self.diagval = float(diagval)
        self.fold_axis = int(fold_axis)
        self.fold_mask = fold_mask
        self.fold_pairs = fold_pairs
        self.fold_mask_b = fold_mask_b

    @property
    def shape(self):
        return self.dia.shape

    @property
    def dtype(self):
        return self.dia.data.dtype

    @property
    def device(self):
        return self.dia.data.device

    def _plane_view(self, x):
        """View of the flat vector x as (n_ax, ..., bs) with the fold axis
        first; writes through it land in x."""
        n0, n1, n2 = self.dia.vshape
        return torch.movedim(x.view(n0, n1, n2, self.dia.bs), self.fold_axis, 0)

    def matvec(self, x):
        m = self.fold_mask
        u = x.clone()
        ug = self._plane_view(u)
        ug[-1] = torch.where(m, ug[0], ug[-1])
        y = self.dia.matvec(u)
        yg = self._plane_view(y)
        yg[0] += torch.where(m, yg[-1], 0)
        yg[-1] = torch.where(m, self.diagval * self._plane_view(x)[-1], yg[-1])
        return y

    def diagonal(self):
        m = self.fold_mask
        d = self.dia.diagonal()
        dg = self._plane_view(d)
        dg[0] += torch.where(m, dg[-1], 0)
        dg[-1] = torch.where(m, self.diagval, dg[-1])
        return d

    def supports_blocked(self):
        """True when the blocked-native solve layout applies: a blocked
        operator whose fold carries its blocked mask."""
        return isinstance(self.dia, BlockDIAMatrix) and self.fold_mask_b is not None

    def matvec_blocked(self, xb):
        """K^T A K matvec on the padded blocked class stack (n_cls, s0, s1,
        s2).  The fold runs per class on the class grids: only classes of
        parity 0 along the fold axis carry the end planes (the refined dims
        are odd), so fold_mask_b is False everywhere else."""
        ax = self.fold_axis
        mb = self.fold_mask_b
        xg = torch.movedim(xb, 1 + ax, 1)  # (n_cls, s_ax, sA, sB)
        u = xg.clone()
        u[:, -1] = torch.where(mb, xg[:, 0], xg[:, -1])
        y = self.dia.matvec_blocked(torch.movedim(u, 1, 1 + ax))
        yg = torch.movedim(y, 1 + ax, 1)  # a view: writes land in y
        yg[:, 0] += torch.where(mb, yg[:, -1], 0)
        yg[:, -1] = torch.where(mb, self.diagval * xg[:, -1], yg[:, -1])
        return y

    def diagonal_blocked(self):
        """diagonal() in the blocked class-stack layout."""
        ax = self.fold_axis
        mb = self.fold_mask_b
        d = self.dia.diagonal_blocked()
        dg = torch.movedim(d, 1 + ax, 1)
        dg[:, 0] += torch.where(mb, dg[:, -1], 0)
        dg[:, -1] = torch.where(mb, self.diagval, dg[:, -1])
        return d

    def to_scipy(self):
        import scipy.sparse as sp

        if self.fold_pairs is None:
            raise ValueError("to_scipy needs the host-side fold pairs")
        N = self.shape[0]
        slaves, masters = self.fold_pairs
        A = self.dia.to_scipy()
        K = sp.lil_matrix((N, N))
        K.setdiag(1.0)
        for s, mm in zip(slaves, masters):
            K[s, s] = 0.0
            K[s, mm] = 1.0
        K = K.tocsr()
        A2 = (K.T @ A @ K).tolil()
        A2[slaves, :] = 0.0
        A2[:, slaves] = 0.0
        for s in slaves:
            A2[s, s] = self.diagval
        return A2.tocsr()


# ---------------------------------------------------------------------------
# host setup (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def _vertex_delta_table(mesh, lat: LatticeInfo):
    """For each sub-cell type t and local vertex a: the lattice delta
    (di, dj, dk) of that vertex relative to the cell's base corner (derived
    from the generator's vertex-id arithmetic in fem/mesh.py)."""
    nx, ny, nz = lat.dims
    n1, n2 = ny + 1, max(nz + 1, 1)
    deltas = np.empty((lat.cells_per_box, mesh.cells.shape[1], 3), dtype=np.int64)
    for t in range(lat.cells_per_box):
        verts = mesh.cells[t]  # cell t of box (0,0,0): vertex ids ARE the deltas
        for a, v in enumerate(verts):
            i = v // (n1 * n2)
            j = (v % (n1 * n2)) // n2
            k = v % n2
            deltas[t, a] = (i, j, k)
    return deltas


def _dof_delta_table(mesh, element, lat: LatticeInfo):
    """(T, ndofs_scalar, 3) integer node deltas on the degree-refined grid:
    node position in refined lattice units = degree * sum_v phi_v(node_ref) *
    vertex_delta (the geometry map is P1/Q1).  For degree 1 this IS the
    vertex delta table."""
    vdeltas = _vertex_delta_table(mesh, lat)
    r = element.degree
    if r == 1:
        return vdeltas
    from ..fem.elements import lagrange_element

    geo = lagrange_element(mesh.cell_type, 1)
    phi = geo.tabulate(element.nodes)  # (nd, nv)
    dd = r * np.einsum("nv,tvd->tnd", phi, vdeltas.astype(np.float64))
    ddi = np.rint(dd).astype(np.int64)
    if np.abs(dd - ddi).max() >= 1e-9:
        raise ValueError("element nodes off the refined lattice")
    return ddi


def _detect_lattice_wrap(mpc, vshape, bs):
    """Check that the MPC is a pure lattice-plane identification: every slave
    has exactly one master with coefficient 1, slaves live on the LAST plane
    of one axis, masters at the same (other-coords, component) on the FIRST
    plane.  Returns (axis, fold_mask over that plane incl. bs, (slaves,
    masters) host arrays); raises ValueError otherwise."""
    if mpc is None or mpc.num_local_slaves == 0:
        raise ValueError("no constraint to fold")
    co = mpc._np_coeffs
    ma = mpc._np_masters
    nzc = (co != 0).sum(axis=1)
    if not ((nzc == 1).all() and np.allclose(co[np.arange(len(co)), np.argmax(co != 0, axis=1)], 1.0)):
        raise ValueError("constraint is not a pure identification (coeff != 1 or >1 master)")
    slaves = np.asarray(mpc.slaves, np.int64)
    masters = ma[np.arange(len(ma)), np.argmax(co != 0, axis=1)]
    n0, n1, n2 = vshape

    def coords_of(dofs):
        blk, comp = dofs // bs, dofs % bs
        i = blk // (n1 * n2)
        j = (blk % (n1 * n2)) // n2
        k = blk % n2
        return np.stack([i, j, k, comp], axis=1)

    cs, cm = coords_of(slaves), coords_of(masters)
    for axis, nax in enumerate((n0, n1, n2)):
        if (cs[:, axis] == nax - 1).all() and (cm[:, axis] == 0).all():
            others = [a for a in range(4) if a != axis]
            if (cs[:, others] == cm[:, others]).all():
                plane_shape = tuple(s for a, s in enumerate((n0, n1, n2)) if a != axis) + (bs,)
                mask = np.zeros(plane_shape, bool)
                mask[tuple(cs[:, a] for a in others)] = True
                return axis, mask, (slaves, masters)
    raise ValueError("constraint is not an axis-plane wrap")


def _uniform_lattice_geometry(mesh, lat: LatticeInfo):
    """(origin, spacing) if mesh.points is exactly the uniform box grid the
    generator produced (nothing rotated/deformed it afterwards), else None."""
    nx, ny, nz_ = lat.dims
    gdim = mesh.gdim
    dims = (nx, ny, nz_)[:gdim]
    shape = tuple(d + 1 for d in dims)
    pts = mesh.points
    if pts.shape[0] != int(np.prod(shape)):
        return None
    origin = pts[0].copy()
    corner = pts[-1]
    spacing = (corner - origin) / np.asarray(dims, pts.dtype)
    if not np.all(np.isfinite(spacing)) or np.any(spacing == 0):
        return None
    scale = np.abs(spacing).max()
    tol = 1e-12 * max(scale, 1.0, np.abs(origin).max() + np.abs(corner).max())
    pts3 = pts.reshape(*shape, gdim)  # view (points are lex-ordered, C-contig)
    for d in range(gdim):
        axis_vals = origin[d] + spacing[d] * np.arange(shape[d])
        bshape = [1] * gdim
        bshape[d] = shape[d]
        if np.abs(pts3[..., d] - axis_vals.reshape(bshape)).max() > tol:
            return None
    return origin, spacing


# ---------------------------------------------------------------------------
# assembly
# ---------------------------------------------------------------------------


def assemble_matrix_lattice(
    form: Form,
    constraint: Optional[MultiPointConstraint] = None,
    bcs=None,
    diagval=1.0,
    dtype=np.float64,
    side_format="fold",
    device=DEFAULT_DEVICE,
):
    """Compile a bilinear form on a lattice mesh into the lean fold operator
    on `device`; call `.assemble()` for the LatticeOperator.  Raises
    ValueError when the constraint is not an axis-plane wrap, and
    NotImplementedError for the formats and forms not ported yet."""
    return CompiledLatticeForm(form, constraint, bcs or [], diagval, dtype, side_format, device)


class CompiledLatticeForm:
    def __init__(self, form, constraint, bcs, diagval, dtype, side_format="fold", device=DEFAULT_DEVICE):
        if side_format != "fold":
            raise NotImplementedError(
                f"side_format={side_format!r} is not ported yet (ROADMAP queue 1, item 14)")
        mpc_r, mpc_c = _mpc_pair(constraint)
        if mpc_r is not mpc_c:
            raise ValueError("lattice path supports square forms with one MPC")
        V = form.test_space
        if form.trial_space is not V:
            raise ValueError("lattice path needs test == trial space")
        mesh = V.mesh
        lat = get_lattice_info(mesh)
        if lat is None:
            raise ValueError("mesh has no lattice info (use create_box/create_rectangle)")
        if not (len(form.terms) == 1 and form.terms[0].integral == "cell"
                and form.terms[0].entities is None):
            raise ValueError("lattice path needs one cell integral over all cells")
        if getattr(V, "is_mixed", False):
            raise ValueError("lattice path: uniform spaces only")
        r = V.element.degree
        if r not in (1, 2):
            raise ValueError("lattice fast path supports degree 1 and 2")
        if r > 1 and getattr(V, "grid_meta", None) is None:
            # degree 2 needs the grid-lex dof numbering, so that dofs are the
            # points of the r-refined lattice (fem/functionspace.py)
            raise ValueError("degree-2 lattice path needs a grid-numbered space (pristine box mesh)")
        self.dtype = np.dtype(dtype)
        if self.dtype.kind == "c":
            raise NotImplementedError("complex lattice assembly is ROADMAP queue 1, item 18")
        self.device = resolve_device(device)
        self.V, self.mesh, self.lat = V, mesh, lat
        self.bcs = bcs
        self.diagval = diagval
        nx, ny, nz_ = lat.dims
        is2d = mesh.tdim == 2
        self.refine = r
        self.r3 = (r, r, 1 if is2d else r)
        self.vshape = (r * nx + 1, r * ny + 1, 1 if is2d else r * nz_ + 1)
        bs = V.block_size
        self.bs = bs
        self.term = form.terms[0]

        # node deltas (refined-grid units) and diagonal offsets
        deltas = _dof_delta_table(mesh, V.element, lat)  # (T, ns, 3)
        T, ns, _ = deltas.shape
        offs = {}
        self.moves = []  # (t, a, b, off_id, da)
        for t in range(T):
            for a in range(ns):
                for b in range(ns):
                    off = tuple(int(v) for v in deltas[t, b] - deltas[t, a])
                    oid = offs.setdefault(off, len(offs))
                    self.moves.append((t, a, b, oid, tuple(int(v) for v in deltas[t, a])))
        self.offsets = tuple(offs.keys())
        self._deltas = deltas
        self._geo_deltas = _vertex_delta_table(mesh, lat)

        bc_mask_np = _bc_masks(V, bcs, self.dtype)
        bc_dofs = np.unique(np.concatenate([bc.dofs for bc in bcs])) if bcs else np.zeros(0, np.int64)
        self._bc_dofs_grid = bc_dofs
        self.mpc = mpc_r

        # lean fold: periodic identification collapses into the stencil and
        # the geometry is a pristine uniform grid, so assembly needs no
        # per-cell arrays at all
        self._fold_axis, fold_mask, self._fold_pairs = _detect_lattice_wrap(mpc_r, self.vshape, bs)
        self._fold_mask = torch.as_tensor(fold_mask, device=self.device)
        geo = None if self.term.coefficients else _uniform_lattice_geometry(mesh, lat)
        if geo is None or not fold_kernel_supported(self):
            raise NotImplementedError(
                "fold forms with coefficients, x-dependent integrands, non-uniform geometry or "
                "a vector space at degree 2 need the element-kernel lean path "
                "(ROADMAP queue 1, item 14)")
        self._origin, self._spacing = geo
        n0, n1, n2 = self.vshape
        keep = (1.0 - bc_mask_np).reshape(n0, n1, n2, bs)
        self._keep_grid = np.moveaxis(keep, -1, 0).astype(_real_dtype(self.dtype))
        # bc-dof multiplicity grid: the diagval weight of the masked assembler,
        # and what the factored ones check against pad - keep
        indg = np.zeros(V.num_dofs, np.float64)
        np.add.at(indg, bc_dofs, 1.0)
        self._bc_ind_grid = np.moveaxis(indg.reshape(n0, n1, n2, bs), -1, 0).copy()
        # degree 2 takes the parity-blocked layout (bs == 1 here)
        self._blocked = r > 1
        self._fold_mask_blocked = None
        if self._blocked:
            self._build_blocked_structure(keep.reshape(n0, n1, n2).astype(_real_dtype(self.dtype)),
                                          fold_mask)
            keep_s, ind_s, pads = self._keep_blocked, self._bc_ind_blocked, self._blocked_pads()
        else:
            keep_s, ind_s, pads = self._keep_grid, self._bc_ind_grid, None
        if len(bc_dofs) == 0:
            # no Dirichlet dof: every mask is the identity, K5's raw table
            self.table = build_fold_table(self)
        else:
            # separable masks go to K1 / K4, any other Dirichlet set to K3
            factors = _detect_factored_masks(keep_s, ind_s, pads)
            self.table = build_fold_table(self, factors, keep_s, ind_s)

    # ------------------------------------------------------------------
    # parity-blocked (degree-2) structure: see BlockDIAMatrix
    # ------------------------------------------------------------------
    def _build_blocked_structure(self, keep_fine, fold_mask):
        """Classify every move by (row parity class, column parity class,
        coarse offset) and build the padded per-class keep, bc and fold
        masks (dolfinx_mpc_tpu/ops/lattice.py:1325-1387, triple order
        included).  keep_fine: host (n0, n1, n2), 1.0 on non-bc dofs."""
        deltas = self._deltas
        r3 = self.r3
        self._cdims = tuple(-(-n // r) for n, r in zip(self.vshape, r3))
        self._classes = tuple(itertools.product(*(range(r) for r in r3)))
        tripmap = {}
        self._bmoves = []  # (t, a, b, trip_id, (sx, sy, sz) corner shift)
        for t, a, b, oid, da in self.moves:
            db_ = tuple(int(v) for v in deltas[t, b])
            cr = tuple(int(da[i]) % r3[i] for i in range(3))
            cc = tuple(db_[i] % r3[i] for i in range(3))
            off = tuple(db_[i] // r3[i] - int(da[i]) // r3[i] for i in range(3))
            m = tripmap.setdefault((cr, cc, off), len(tripmap))
            self._bmoves.append((t, a, b, m, tuple(int(da[i]) // r3[i] for i in range(3))))
        trips = tuple(tripmap.keys())
        # triples ordered by row x-parity, as the JAX package orders them (its
        # Pallas SpMV slices one row x-parity at a time), so data planes
        # compare index for index
        order = sorted(range(len(trips)), key=lambda m: trips[m][0][0])
        remap = {old: new for new, old in enumerate(order)}
        self.trips = tuple(trips[o] for o in order)
        self._bmoves = [(t, a, b, remap[m], sh) for t, a, b, m, sh in self._bmoves]
        self._keep_blocked = self._split_classes(np.asarray(keep_fine))
        ind = np.zeros(int(np.prod(self.vshape)), np.float64)
        np.add.at(ind, np.asarray(self._bc_dofs_grid, np.int64), 1.0)
        self._bc_ind_blocked = self._split_classes(ind.reshape(self.vshape))
        # blocked fold mask: per class, the perpendicular-plane identification
        # mask on the class grid; only classes with parity 0 along the fold
        # axis take part (both end planes are even: refined dims are odd).
        # Shape (n_cls, sA, sB), (A, B) the other axes in order; padded slots
        # are False.
        ax = self._fold_axis
        mf = np.asarray(fold_mask).reshape(fold_mask.shape[0], fold_mask.shape[1])  # bs == 1
        perp = [a for a in range(3) if a != ax]
        mb = np.zeros((len(self._classes), self._cdims[perp[0]], self._cdims[perp[1]]), bool)
        for i, pc in enumerate(self._classes):
            if pc[ax] != 0:
                continue
            g = mf[pc[perp[0]]::r3[perp[0]], pc[perp[1]]::r3[perp[1]]]
            mb[i, : g.shape[0], : g.shape[1]] = g
        self._fold_mask_blocked = torch.as_tensor(mb, device=self.device)

    def _split_classes(self, fine):
        """(n0, n1, n2) host grid -> (n_cls, s0, s1, s2) padded class stack."""
        r3 = self.r3
        out = np.zeros((len(self._classes),) + self._cdims, fine.dtype)
        for i, (p0, p1, p2) in enumerate(self._classes):
            g = fine[p0::r3[0], p1::r3[1], p2::r3[2]]
            out[i, : g.shape[0], : g.shape[1], : g.shape[2]] = g
        return out

    def _blocked_pads(self):
        """Per-class real-slot factors (pi, pj, pk), each (n_cls, s_axis):
        1 where the class grid holds a dof, 0 on its padding
        (dolfinx_mpc_tpu/ops/pallas_lattice.py:228-238)."""
        pads = [np.zeros((len(self._classes), s)) for s in self._cdims]
        for c, pc in enumerate(self._classes):
            for d in range(3):
                pads[d][c, : -(-(self.vshape[d] - pc[d]) // self.r3[d])] = 1.0
        return tuple(pads)

    # ------------------------------------------------------------------
    def _zero_bc_on_grid(self, data, keep_grid):
        """Zero bc rows/cols directly on the DIA data: entry (r, r+off) dies
        iff r or r+off is a bc dof — what K1's factored masks and K3's
        stacks do inside the kernel."""
        if len(self._bc_dofs_grid) == 0:
            return data
        kb = keep_grid.to(data.dtype)  # (bs, n0, n1, n2)
        n0, n1, n2 = self.vshape
        out = data.clone()
        for d, (di, dj, dk) in enumerate(self.offsets):
            src = (slice(None),
                   slice(max(di, 0), n0 + min(di, 0)),
                   slice(max(dj, 0), n1 + min(dj, 0)),
                   slice(max(dk, 0), n2 + min(dk, 0)))
            pad = (max(-dk, 0), max(dk, 0), max(-dj, 0), max(dj, 0), max(-di, 0), max(di, 0))
            kcol = torch.nn.functional.pad(kb[src], pad)  # (bs, n0, n1, n2)
            for ci in range(self.bs):
                for cj in range(self.bs):
                    out[d, ci, cj] *= kb[ci] * kcol[cj]
        return out

    def _diag_adds(self, data, diagval):
        """Add diagval on the Dirichlet diagonals."""
        n0, n1, n2 = self.vshape
        zid = self.offsets.index((0, 0, 0))
        out = data.clone()
        if len(self._bc_dofs_grid):
            dg = torch.zeros(self.V.num_dofs, dtype=data.dtype, device=data.device)
            dg.index_add_(0, torch.as_tensor(self._bc_dofs_grid, device=data.device),
                          torch.full((len(self._bc_dofs_grid),), float(diagval),
                                     dtype=data.dtype, device=data.device))
            dg = dg.reshape(n0, n1, n2, self.bs)
            for ci in range(self.bs):
                out[zid, ci, ci] += dg[..., ci]
        return out

    def _zero_bc_blocked(self, data, keep_blocked):
        """Blocked analogue of _zero_bc_on_grid: entry (r, r+off) dies iff
        either end is a bc dof, per class pair on the padded grids — what
        K4's factored masks and K3's stacks do inside the kernel."""
        if len(self._bc_dofs_grid) == 0:
            return data
        s0, s1, s2 = self._cdims
        cls_id = {c: i for i, c in enumerate(self._classes)}
        kb = keep_blocked.to(data.dtype)
        out = data.clone()
        for m, (cr, cc, (di, dj, dk)) in enumerate(self.trips):
            src = (cls_id[cc],
                   slice(max(di, 0), s0 + min(di, 0)),
                   slice(max(dj, 0), s1 + min(dj, 0)),
                   slice(max(dk, 0), s2 + min(dk, 0)))
            pad = (max(-dk, 0), max(dk, 0), max(-dj, 0), max(dj, 0), max(-di, 0), max(di, 0))
            out[m] *= kb[cls_id[cr]] * torch.nn.functional.pad(kb[src], pad)
        return out

    def _diag_adds_blocked(self, data, diagval):
        """Add diagval times the bc multiplicity on the blocked diagonal
        triples."""
        if len(self._bc_dofs_grid) == 0:
            return data
        db = torch.as_tensor(self._bc_ind_blocked, dtype=data.dtype, device=data.device)
        cls_id = {c: i for i, c in enumerate(self._classes)}
        out = data.clone()
        for m, (cr, cc, off) in enumerate(self.trips):
            if cr == cc and off == (0, 0, 0):
                out[m] += diagval * db[cls_id[cr]]
        return out

    def _assemble_fold_lean_kernel(self, jitter, diagval):
        """The lean fold operator through one assembler launch, BC masks and
        diagval fused into the pass that writes the data: K5 for a form
        without Dirichlet dofs (dolfinx_mpc_tpu/ops/lattice.py:865-880,
        where the JAX package takes its unmasked kernel), else K1 (degree 1)
        or K4 (degree 2, blocked) for a separable Dirichlet set, K3
        otherwise."""
        n0, n1, n2 = self.vshape
        tab = self.table.on(self.device, torch_dtype(_real_dtype(self.dtype)))
        if self.table.factors is None and self.table.keep is None:
            data = assemble_fold_lean_raw(tab, jitter)
        elif self.table.factors is None:
            data = assemble_fold_lean_masked(tab, jitter, diagval)
        elif self._blocked:
            data = assemble_fold_lean_blocked(tab, jitter, diagval)
        else:
            data = assemble_fold_lean_factored(tab, jitter, diagval)
        if self._blocked:
            dia = BlockDIAMatrix(data, self.trips, self.vshape, self.r3)
        else:
            dia = DIAMatrix(data.reshape(len(self.offsets), self.bs, self.bs, n0, n1, n2),
                            self.offsets, self.vshape, self.bs)
        return LatticeOperator(dia, diagval, self._fold_axis, self._fold_mask, self._fold_pairs,
                               fold_mask_b=self._fold_mask_blocked)

    def assemble(self) -> LatticeOperator:
        return self._assemble_fold_lean_kernel(0.0, self.diagval)
