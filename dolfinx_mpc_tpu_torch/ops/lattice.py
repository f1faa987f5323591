"""Lattice fast path (torch): scatter-free assembly and stencil SpMV for
structured box meshes.

Counterpart of ``dolfinx_mpc_tpu/ops/lattice.py``.  On a structured box
mesh the sparsity is a stencil: the (cell, a, b) -> entry map collapses to a
fixed set of lattice diagonal offsets, so the matrix is a DIA array and SpMV
is a sum of shifted products.  Degree 2 keeps the same idea on the
parity-blocked layout (``BlockDIAMatrix``): the refined grid splits into
parity classes (8 in 3-D, 4 in 2-D), and each (row class, column class,
coarse offset) triple holds one value per coarse box.  The constraint
enters in one of three side formats:

- "fold": a periodic constraint that identifies the last lattice plane of
  one axis with the first is applied inside the operator: u = K x copies
  the master plane onto the slave plane, y = A u, the slave-plane rows fold
  back onto the masters (K^T), and slave rows get diagval — K^T A K without
  any irregular operation;
- "csr" (the default): the slave cells leave the stencil and their
  eliminated K^H A_e K blocks, with the slave diagonal, are assembled over
  static slots into a small CSR side matrix;
- "cells": the same blocks kept per slave cell, applied as a gather, a
  batched product and an index_add_.

The lean fold forms of 3-D tetrahedra with a constant feature matrix (scalar
at degree 1 or 2, bs <= 3 at degree 1) assemble from a per-plane table
reduced on the host (ops/lattice_kernels.py: build_fold_table) through
kernel K1 or K4 when the Dirichlet set is separable, K3 when it is not and
K5 when the form has none.  Every other form — 2-D meshes, x-dependent or
coefficient integrands, non-uniform geometry, vector spaces at degree 2,
and the "csr" and "cells" formats — runs the element kernel of ops/kernels.py
and packs its tensors into the DIA data with strided slice adds.  Every
scalar DIA matvec on the card runs kernel K2, every vector (bs > 1) one K7
and every blocked one K6; the side products are plain torch, as the JAX
package's segment_sum is XLA.  Complex dtypes (complex64, complex128) take
the JAX package's routes for them: never the assemblers (its Pallas
assemblers are float32 only), the lean element-kernel path for fold forms
without coefficients, the cells path otherwise; the element tensors are
real for real forms and are cast to the complex dtype before packing, and
the SpMVs run their complex instantiations.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from .._dtypes import torch_dtype
from ..fem.forms import Form
from ..fem.lattice_info import LatticeInfo, get_lattice_info
from ..fem.quadrature import quadrature_rule
from ..la.sparse import build_slot_pattern
from ..multipointconstraint import MultiPointConstraint
from ..utils.timing import traced
from .assemble import _bc_masks, _build_cell_transforms, _coeff_vectors, _mpc_pair, _real_dtype
from .kernels import compile_term
from .soa_kernels import _soa_degree, compile_cell_kernel_soa, soa_supported
from .lattice_kernels import (
    BlockedMatvecLaunch,
    DiaBsMatvecLaunch,
    DiaMatvecLaunch,
    _detect_factored_masks,
    assemble_fold_lean_blocked,
    assemble_fold_lean_factored,
    assemble_fold_lean_masked,
    assemble_fold_lean_raw,
    blocked_matvec,
    build_fold_table,
    dia_matvec,
    dia_matvec_bs,
    fold_kernel_supported,
)

__all__ = ["DIAMatrix", "BlockDIAMatrix", "LatticeOperator", "CompiledLatticeForm",
           "assemble_matrix_lattice", "soa_supported"]


def _scalar(v, dtype):
    """A Python scalar of the operator's kind: complex for a complex dtype,
    else the real part (the JAX package's diagval rule,
    dolfinx_mpc_tpu/ops/assemble.py:350)."""
    return complex(v) if dtype.is_complex else float(np.real(v))


# ---------------------------------------------------------------------------
# DIA matrix: data per diagonal offset over the vertex lattice
# ---------------------------------------------------------------------------


class DIAMatrix:
    """Stencil matrix over an (n0, n1, n2) vertex lattice with `bs` dof
    components per vertex.

    data: (n_off, bs, bs, n0, n1, n2) — entry A[(v, ci), (v+off_d, cj)] =
    data[d, ci, cj, v].  On the card the first matvec prepares the launch of
    K2 (bs = 1, DiaMatvecLaunch) or K7 (bs > 1, DiaBsMatvecLaunch) and keeps
    it for the next ones.
    """

    def __init__(self, data, offsets, vshape, bs):
        self.data = data
        self.offsets = tuple(tuple(int(v) for v in o) for o in offsets)
        self.vshape = tuple(int(v) for v in vshape)
        self.bs = int(bs)
        self._launch = None

    @property
    def shape(self):
        n = int(np.prod(self.vshape)) * self.bs
        return (n, n)

    def matvec(self, x):
        """K2 (bs = 1) or K7 (bs > 1) on the card, one launch; their plain
        version on the CPU."""
        if self._launch is None and self.data.device.type == "cuda":
            self._launch = (DiaMatvecLaunch(self.data, self.offsets, self.vshape) if self.bs == 1
                            else DiaBsMatvecLaunch(self.data, self.offsets, self.vshape, self.bs))
        if self._launch is not None:
            return self._launch(x)
        if self.bs == 1:
            return dia_matvec(self.data, self.offsets, self.vshape, x)
        return dia_matvec_bs(self.data, self.offsets, self.vshape, self.bs, x)

    def abs(self):
        """The entrywise |A|: the same stencil over |data|, every other field
        carried; its launch is its own, prepared by its first matvec."""
        out = copy.copy(self)
        out.data, out._launch = torch.abs(self.data), None
        return out

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
        self._launch = None  # K6's, prepared by the first matvec on the card

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

    @traced("lattice.to_blocked")
    def to_blocked(self, x):
        """fine (n0, n1, n2) flat vector -> (n_classes, s0, s1, s2) padded
        class stack (class-major split by refined parity), the layout of
        matvec_blocked; the padding holds zeros."""
        n0, n1, n2 = self.vshape
        r0, r1, r2 = self.r3
        s0, s1, s2 = self.cdims
        xp = torch.nn.functional.pad(x.reshape(n0, n1, n2),
                                     (0, r2 * s2 - n2, 0, r1 * s1 - n1, 0, r0 * s0 - n0))
        return (xp.reshape(s0, r0, s1, r1, s2, r2).permute(1, 3, 5, 0, 2, 4)
                .reshape(-1, s0, s1, s2))

    @traced("lattice.from_blocked")
    def from_blocked(self, yb):
        """(n_classes, s0, s1, s2) padded class stack -> fine flat vector:
        to_blocked's inverse, the padding dropped."""
        n0, n1, n2 = self.vshape
        r0, r1, r2 = self.r3
        s0, s1, s2 = self.cdims
        yf = (yb.reshape(r0, r1, r2, s0, s1, s2).permute(3, 0, 4, 1, 5, 2)
              .reshape(r0 * s0, r1 * s1, r2 * s2))
        return yf[:n0, :n1, :n2].reshape(-1)

    def matvec(self, x):
        return self.from_blocked(self.matvec_blocked(self.to_blocked(x)))

    def matvec_blocked(self, xb):
        """SpMV on the padded blocked class stack (n_cls, s0, s1, s2), the
        solve path's layout: one launch of kernel K6 (BlockedMatvecLaunch,
        prepared once) on the card, the plain halo-pad slice-FMA on the
        CPU.  Padded slots stay exact zeros."""
        if self._launch is None and self.data.device.type == "cuda":
            self._launch = BlockedMatvecLaunch(self.data, self.trips, self.classes)
        if self._launch is not None:
            return self._launch(xb.contiguous())
        return blocked_matvec(self.data, self.trips, self.classes, xb)

    abs = DIAMatrix.abs

    def diagonal_blocked(self):
        """Diagonal as the padded blocked class stack (n_cls, s0, s1, s2)."""
        cls_id = {c: i for i, c in enumerate(self.classes)}
        out = torch.zeros((len(cls_id),) + self.cdims, dtype=self.data.dtype, device=self.data.device)
        for m, (cr, cc, off) in enumerate(self.trips):
            if cr == cc and off == (0, 0, 0):
                out[cls_id[cr]] = self.data[m]
        return out

    def diagonal(self):
        return self.from_blocked(self.diagonal_blocked())

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
    """DIA (or parity-blocked) stencil plus the constraint's corrections, in
    one of three forms:

    - the periodic fold (fold_axis set): K^T A K with the slave plane's rows
      and columns replaced by diagval on the diagonal.  fold_mask: bool
      (plane shape + (bs,)) marking the slaves of that plane; fold_pairs:
      host (slaves, masters) arrays, needed only by to_scipy(); fold_mask_b:
      on a BlockDIAMatrix, the blocked fold mask (n_cls, sA, sB) over the
      class grids of the two other axes, which the blocked-native
      matvec_blocked needs;
    - the "csr" side: the slave cells' eliminated K^H A_e K blocks and the
      slave diagonal assembled over static slots (side_data at side_rows,
      side_cols), a gather, a product and an index_add_ per matvec (the JAX
      package's segment_sum);
    - the "cells" side: the same blocks unassembled, side_Aep (n_sc, W, W)
      over the dof table side_er (n_sc, W), -1 replaced by the trash index
      N, plus diagval on `slaves`: a gather, a batched product and an
      index_add_ per matvec.

    The DIA part of either side format holds every non-slave cell and the
    Dirichlet diagonal (dolfinx_mpc_tpu/ops/lattice.py:407-613)."""

    def __init__(self, dia, diagval=1.0, fold_axis=None, fold_mask=None, fold_pairs=None, fold_mask_b=None, *,
                 side_data=None, side_cols=None, side_rows=None, side_nrows=None, side_Aep=None, side_er=None,
                 slaves=None):
        self.dia = dia
        self.diagval = _scalar(diagval, dia.data.dtype)
        self.fold_axis = None if fold_axis is None else int(fold_axis)
        self.fold_mask = fold_mask
        self.fold_pairs = fold_pairs
        self.fold_mask_b = fold_mask_b
        self.side_data = side_data
        self.side_cols = side_cols
        self.side_rows = side_rows
        self.side_nrows = side_nrows
        self.side_Aep = side_Aep
        self.side_er = side_er
        self.slaves = slaves

    @property
    def shape(self):
        return self.dia.shape

    @property
    def dtype(self):
        return self.dia.data.dtype

    @property
    def device(self):
        return self.dia.data.device

    def _unassembled(self):
        return self.side_Aep is not None

    def _has_csr_side(self):
        return self.side_data is not None and self.side_data.shape[0] > 0

    def _plane_view(self, x):
        """View of the flat vector x as (n_ax, ..., bs) with the fold axis
        first; writes through it land in x."""
        n0, n1, n2 = self.dia.vshape
        return torch.movedim(x.view(n0, n1, n2, self.dia.bs), self.fold_axis, 0)

    def _cells_product(self, x):
        """sum over the slave cells of Aep_c x[er_c], scattered to er_c
        (length N + 1: the trash row N collects the padded entries)."""
        n = self.shape[0]
        xe = torch.cat([x, x.new_zeros(1)])[self.side_er]  # (n_sc, W)
        ye = torch.bmm(self.side_Aep, xe.unsqueeze(-1)).squeeze(-1)
        yp = x.new_zeros(n + 1)
        return yp.index_add_(0, self.side_er.reshape(-1), ye.reshape(-1))[:n]

    def matvec(self, x):
        if self.fold_axis is not None:
            m = self.fold_mask
            u = x.clone()
            ug = self._plane_view(u)
            ug[-1] = torch.where(m, ug[0], ug[-1])
            y = self.dia.matvec(u)
            yg = self._plane_view(y)
            yg[0] += torch.where(m, yg[-1], 0)
            yg[-1] = torch.where(m, self.diagval * self._plane_view(x)[-1], yg[-1])
            return y
        return self._add_side(x, self.dia.matvec(x))

    def _add_side(self, x, y):
        """y += the side blocks' product with x ("csr" or "cells"); y."""
        if self._unassembled():
            if self.side_Aep.shape[0]:
                y += self._cells_product(x)
            if self.slaves is not None and self.slaves.shape[0]:
                y.index_add_(0, self.slaves, self.diagval * x[self.slaves])
        elif self._has_csr_side():
            y.index_add_(0, self.side_rows, self.side_data * x[self.side_cols])
        return y

    def diagonal(self):
        d = self.dia.diagonal()
        if self.fold_axis is not None:
            m = self.fold_mask
            dg = self._plane_view(d)
            dg[0] += torch.where(m, dg[-1], 0)
            dg[-1] = torch.where(m, self.diagval, dg[-1])
            return d
        if self._unassembled():
            if self.side_Aep.shape[0]:
                de = torch.diagonal(self.side_Aep, dim1=1, dim2=2)  # (n_sc, W)
                dp = d.new_zeros(self.shape[0] + 1)
                d = d + dp.index_add_(0, self.side_er.reshape(-1), de.reshape(-1))[: self.shape[0]]
            if self.slaves is not None and self.slaves.shape[0]:
                d.index_add_(0, self.slaves, torch.full(self.slaves.shape, self.diagval, dtype=d.dtype,
                                                        device=d.device))
            return d
        if self._has_csr_side():
            on_diag = torch.where(self.side_rows == self.side_cols, self.side_data, 0)
            d.index_add_(0, self.side_rows, on_diag)
        return d

    def abs(self):
        """The entrywise |A| in the same representation: |dia|, |diagval| and
        the side blocks' values made absolute, every other field carried.
        Every matvec path is an additive gather, so |A| . 1 bounds the row
        sums of |K^H A K| (the Gershgorin bound).  Real for a complex
        operator, as the JAX package's bound is."""
        out = copy.copy(self)
        out.dia = self.dia.abs()
        out.diagval = _scalar(abs(self.diagval), out.dtype)
        out.side_data = None if self.side_data is None else torch.abs(self.side_data)
        out.side_Aep = None if self.side_Aep is None else torch.abs(self.side_Aep)
        return out

    def supports_blocked(self):
        """True when the blocked-native solve layout applies: a blocked
        operator without side blocks, whose fold (if any) carries its
        blocked mask."""
        return (isinstance(self.dia, BlockDIAMatrix) and not self._unassembled() and not self._has_csr_side()
                and (self.fold_axis is None or self.fold_mask_b is not None))

    def _blocked_dia(self):
        if not self.supports_blocked():
            raise ValueError("the padded class-stack layout needs a BlockDIAMatrix operator without side blocks "
                             f"(this one holds a {type(self.dia).__name__})")
        return self.dia

    def to_blocked(self, x):
        """The flat vector x as the padded class stack (n_cls, s0, s1, s2)
        that matvec_blocked takes (BlockDIAMatrix.to_blocked); ValueError
        where supports_blocked() is False."""
        return self._blocked_dia().to_blocked(x)

    def from_blocked(self, xb):
        """The padded class stack xb as the flat vector (to_blocked's
        inverse); ValueError where supports_blocked() is False."""
        return self._blocked_dia().from_blocked(xb)

    def matvec_blocked(self, xb):
        """K^T A K matvec on the padded blocked class stack (n_cls, s0, s1,
        s2).  The fold runs per class on the class grids: only classes of
        parity 0 along the fold axis carry the end planes (the refined dims
        are odd), so fold_mask_b is False everywhere else."""
        if self.fold_axis is None:
            return self.dia.matvec_blocked(xb)
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
        d = self.dia.diagonal_blocked()
        if self.fold_axis is None:
            return d
        ax = self.fold_axis
        mb = self.fold_mask_b
        dg = torch.movedim(d, 1 + ax, 1)
        dg[:, 0] += torch.where(mb, dg[:, -1], 0)
        dg[:, -1] = torch.where(mb, self.diagval, dg[:, -1])
        return d

    def to_scipy(self):
        import scipy.sparse as sp

        N = self.shape[0]
        if self.fold_axis is not None:
            if self.fold_pairs is None:
                raise ValueError("to_scipy needs the host-side fold pairs")
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
        A = self.dia.to_scipy()
        rows, cols, vals = [], [], []
        if self._unassembled():
            er = self.side_er.cpu().numpy()
            Aep = self.side_Aep.detach().cpu().numpy()
            for c in range(er.shape[0]):
                ok = er[c] < N
                ii = er[c][ok]
                vals.append(Aep[c][np.ix_(ok, ok)].ravel())
                rows.append(np.repeat(ii, len(ii)))
                cols.append(np.tile(ii, len(ii)))
            if self.slaves is not None and self.slaves.shape[0]:
                sl = self.slaves.cpu().numpy()
                rows.append(sl)
                cols.append(sl)
                vals.append(np.full(len(sl), self.diagval))
        elif self._has_csr_side():
            rows.append(self.side_rows.cpu().numpy())
            cols.append(self.side_cols.cpu().numpy())
            vals.append(self.side_data.detach().cpu().numpy())
        if not rows:
            return A.tocsr()
        side = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))), shape=(N, N))
        return (A.tocsr() + side).tocsr()


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


# values of the element kernel's vmapped intermediates per chunk of cells,
# counted as nq nd^2 (1 + gdim) bs per cell: bounds the working set of the
# element-kernel paths (vector P2 elasticity at n=32 has 196,608 cells of
# 30 x 30 tensors)
ELEMENT_CHUNK_VALUES = 2 ** 27


def assemble_matrix_lattice(
    form: Form,
    constraint: Optional[MultiPointConstraint] = None,
    bcs=None,
    diagval=1.0,
    dtype=np.float64,
    side_format="csr",
    device=DEFAULT_DEVICE,
):
    """Compile a bilinear form on a lattice mesh into DIA + side block on
    `device`; call `.assemble()` for the LatticeOperator.

    side_format "csr" assembles the constraint's side into static-slot CSR;
    "cells" keeps it as per-slave-cell eliminated blocks (the same operator;
    only where soa_supported holds, as in the JAX package); "fold"
    collapses a periodic plane-wrap constraint into the stencil and raises
    ValueError for any other constraint: a pure identification (one master
    of coefficient 1 per slave), so a Bloch phase (coefficient e^{i theta})
    takes "csr" or "cells".  A complex dtype takes the element-kernel
    paths, never the CUDA assemblers."""
    return CompiledLatticeForm(form, constraint, bcs or [], diagval, dtype, side_format, device)


class CompiledLatticeForm:
    """The host tables of one lattice form and the route its assembly takes
    (dolfinx_mpc_tpu/ops/lattice.py:745-1001):

    - "kernel": fold, uniform geometry, a constant feature matrix in 3-D at
      degree 1 (bs <= 3) or scalar degree 2, a real dtype — the CUDA
      assemblers K1, K3, K4 and K5 (_assemble_fold_lean_kernel);
    - "lean": every other fold form on uniform geometry without
      coefficients (2-D meshes, x-dependent integrands, vector spaces at
      degree 2, complex dtypes) — the element kernel on coordinates
      synthesized on the device, packed without any scatter, the Dirichlet
      rows and columns zeroed on the grid (_assemble_fold_lean, and at
      scalar degree 2 the parity-blocked _assemble_fold_lean_blocked);
    - "cells": coefficient forms, non-uniform geometry and the "csr" and
      "cells" side formats — the element kernel on the real cell
      coordinates, element-level Dirichlet masks, and for the side formats
      the slave cells out of the stencil and their K^H A_e K into the side
      (_assemble_impl).

    The element kernel is the cells-last SoA kernel (ops/soa_kernels.py)
    wherever soa_supported holds, as in the JAX package; elsewhere it
    is ops/kernels.py's cell-first vmapped one, at the SoA kernel's
    quadrature degree on the fold paths and at compile_term's default in the
    generic csr path.  Coordinates (nv, gdim, c), coefficient dof maps
    (nd_w * bs_w, c), keep masks (nd, c) and element tensors (nd, nd, c) are
    held cells last either way."""

    def __init__(self, form, constraint, bcs, diagval, dtype, side_format="csr", device=DEFAULT_DEVICE):
        if side_format not in ("csr", "cells", "fold"):
            raise ValueError(f"unknown side_format {side_format!r}")
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
        self.device = resolve_device(device)
        self.side_format = side_format
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
        self.soa = soa_supported(mesh, V, V, self.term)
        if side_format == "cells" and not self.soa:
            raise ValueError("side_format='cells' needs a form the SoA kernel takes (soa_supported)")

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
        self._fold_axis = self._fold_mask = self._fold_pairs = self._fold_mask_blocked = None
        self._blocked = False
        rdt = torch_dtype(_real_dtype(self.dtype))

        if side_format == "fold":
            self._fold_axis, fold_mask, self._fold_pairs = _detect_lattice_wrap(mpc_r, self.vshape, bs)
            self._fold_mask = torch.as_tensor(fold_mask, device=self.device)
            geo = None if self.term.coefficients else _uniform_lattice_geometry(mesh, lat)
            if geo is not None:
                # lean fold: the geometry is a pristine uniform grid, so
                # assembly needs no per-cell host arrays at all
                self._origin, self._spacing = geo
                n0, n1, n2 = self.vshape
                keep = (1.0 - bc_mask_np).reshape(n0, n1, n2, bs)
                self._keep_grid = np.moveaxis(keep, -1, 0).astype(_real_dtype(self.dtype))
                # bc-dof multiplicity grid: the diagval weight of the masked
                # assembler, and what the factored ones check against pad - keep
                indg = np.zeros(V.num_dofs, np.float64)
                np.add.at(indg, bc_dofs, 1.0)
                self._bc_ind_grid = np.moveaxis(indg.reshape(n0, n1, n2, bs), -1, 0).copy()
                # degree 2 at bs = 1 takes the parity-blocked layout
                self._blocked = r > 1 and bs == 1
                if self._blocked:
                    self._build_blocked_structure(keep.reshape(n0, n1, n2).astype(_real_dtype(self.dtype)),
                                                  fold_mask)
                if fold_kernel_supported(self):
                    self._route = "kernel"
                    self._build_kernel_table(bc_dofs)
                else:
                    self._route = "lean"
                    self._compile_element_kernel(True)
                return
        self._route = "cells"
        self._compile_element_kernel(self.soa or side_format == "fold")
        # cells t-major (t, i, j, k), the JAX package's SoA order: each grid
        # slice of the element tensors is then one box-grid block
        nzc = 1 if is2d else nz_
        perm = np.arange(mesh.num_cells).reshape(nx, ny, nzc, T).transpose(3, 0, 1, 2).reshape(-1)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(len(perm))
        as_t = lambda a, dt=torch.int64: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.device)  # noqa: E731
        self._coords = as_t(mesh.points[mesh.cells[perm]].transpose(1, 2, 0), rdt)  # (nv, gdim, c)
        self._keep_cells = as_t((1.0 - bc_mask_np[V.dofmap[perm]]).T, rdt)  # (nd, c)
        self._wdofmaps = {n: as_t(f.function_space.dofmap[perm].T) for n, f in self.term.coefficients.items()}
        if side_format == "fold":
            return

        # the constraint's side over the slave cells (JAX :912-946)
        tr = _build_cell_transforms(V, mpc_r, self.dtype)
        sc = np.flatnonzero(tr.slave_cell_mask)
        self._slave_cells = as_t(tr.slave_cell_mask[perm], rdt)  # (c,) 1.0 on slave cells
        self._sc = as_t(inv_perm[sc])  # t-major positions of the slave cells, mesh order
        N = V.num_dofs
        slaves_row = (np.asarray(mpc_r.slaves, np.int64) if (mpc_r is not None and mpc_r.num_local_slaves)
                      else np.zeros(0, np.int64))
        tdt = torch_dtype(self.dtype)  # the constraint's coefficients: complex for a Bloch phase
        self._Tr = as_t(tr.T, tdt) if len(sc) else torch.zeros((0, V.ndofs_cell, 1), dtype=tdt, device=self.device)
        if side_format == "cells":
            er = tr.ext_dofs if len(sc) else np.zeros((0, 1), np.int64)
            self._er = as_t(np.where(er >= 0, er, N))
            self._slaves = as_t(slaves_row)
            return
        batches, masks = [], []
        if len(sc):
            er = tr.ext_dofs  # (n_sc, W)
            rr = np.broadcast_to(er[:, :, None], (len(sc), er.shape[1], er.shape[1]))
            cc = np.broadcast_to(er[:, None, :], rr.shape)
            batches.append((rr, cc))
            masks.append((rr >= 0) & (cc >= 0))
        else:
            batches.append((np.zeros((0, 1, 1), np.int64), np.zeros((0, 1, 1), np.int64)))
            masks.append(None)
        batches.append((slaves_row, slaves_row))
        masks.append(None)
        self.pattern = build_slot_pattern((N, N), batches, masks)
        self._slots = as_t(np.concatenate(self.pattern.slots))
        self._side_cols = as_t(self.pattern.indices)
        self._side_rows = as_t(self.pattern.row_ids)
        self.n_slaves_diag = slaves_row.shape[0]

    def _build_kernel_table(self, bc_dofs):
        """The host table of the CUDA assemblers (ops/lattice_kernels.py:
        build_fold_table): K5's raw table without Dirichlet dofs, else the
        separable masks of K1 / K4 or K3's stacks."""
        if self._blocked:
            keep_s, ind_s, pads = self._keep_blocked, self._bc_ind_blocked, self._blocked_pads()
        else:
            keep_s, ind_s, pads = self._keep_grid, self._bc_ind_grid, None
        if len(bc_dofs) == 0:
            self.table = build_fold_table(self)
        else:
            factors = _detect_factored_masks(keep_s, ind_s, pads)
            self.table = build_fold_table(self, factors, keep_s, ind_s)

    def _compile_element_kernel(self, soa_degree):
        """The element kernels of the form: the SoA kernel where soa_degree
        is asked for and soa_supported holds (else None), and the
        cell-first kernel at the SoA kernel's quadrature degree (soa_degree)
        or at compile_term's default."""
        term = self.term
        if soa_degree:
            term = dataclasses.replace(term, quad_degree=_soa_degree(term, self.refine))
        self._soa_kernel = (compile_cell_kernel_soa(self.mesh, self.V, self.V, self.term, self.dtype)
                            if soa_degree and self.soa else None)
        self._kernel = compile_term(term, self.V, self.V).kernel
        qdeg = term.quad_degree if term.quad_degree is not None else 3 * self.refine
        self._nq = len(quadrature_rule(self.mesh.ref_cell, qdeg)[1])

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
                          torch.full((len(self._bc_dofs_grid),), _scalar(diagval, data.dtype),
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
        dv = _scalar(diagval, data.dtype)
        for m, (cr, cc, off) in enumerate(self.trips):
            if cr == cc and off == (0, 0, 0):
                out[m] += dv * db[cls_id[cr]]
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

    # ------------------------------------------------------------------
    # the element-kernel paths
    # ------------------------------------------------------------------
    def _element_tensors(self, coords, wlocals):
        """(nd, nd, c) element tensors, in the operator's dtype, of the
        cells `coords` (nv, gdim, c) with their local coefficient values
        (nd_w * bs_w, c) by name: the SoA kernel where the form has one,
        else _cell_first_tensors."""
        if self._soa_kernel is None:
            return self._cell_first_tensors(coords, wlocals)
        wl = {}
        for n, f in self.term.coefficients.items():
            W = f.function_space
            wl[n] = wlocals[n].reshape(W.element.ndofs, W.block_size, -1)
        return self._soa_kernel(coords, wl).to(torch_dtype(self.dtype))

    def _cell_first_tensors(self, coords, wlocals):
        """_element_tensors through the cell-first kernel (ops/kernels.py),
        ELEMENT_CHUNK_VALUES of its intermediates at a time."""
        n = coords.shape[-1]
        nd = self.V.ndofs_cell
        chunk = max(1, ELEMENT_CHUNK_VALUES // (self._nq * nd * nd * (1 + self.mesh.gdim) * self.bs))
        # the operator's dtype: a real kernel's values go into a complex
        # tensor unchanged (zero imaginary part), as the JAX package's SoA
        # kernel writes them in a complex dtype
        out = torch.empty((nd, nd, n), dtype=torch_dtype(self.dtype), device=coords.device)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            Ae = self._kernel(coords[..., lo:hi].permute(2, 0, 1), None,
                              {k: v[:, lo:hi].T for k, v in wlocals.items()})
            out[:, :, lo:hi] = Ae.permute(1, 2, 0)
        return out

    def _synth_coords(self, jitter):
        """Cell-corner coordinates (nv, gdim, c) of the pristine uniform
        lattice, cells t-major, made on the device from aranges
        (dolfinx_mpc_tpu/ops/lattice.py:1236-1272); `jitter` scales the
        geometry, as bench.py's does."""
        nx, ny, nz_ = self.lat.dims
        nzc = 1 if self.mesh.tdim == 2 else nz_
        T = self.lat.cells_per_box
        nv = self._geo_deltas.shape[1]
        dt = torch_dtype(_real_dtype(self.dtype))
        base = [torch.arange(m, dtype=dt, device=self.device).reshape(shape)
                for m, shape in ((nx, (1, nx, 1, 1)), (ny, (1, 1, ny, 1)), (nzc, (1, 1, 1, nzc)))]
        scale = 1.0 + float(jitter)
        comps = []
        for d in range(self.mesh.gdim):
            deltas_d = torch.as_tensor(self._geo_deltas[:, :, d].T.reshape(nv, T, 1, 1, 1), dtype=dt,
                                       device=self.device)
            # Python-float origin and spacing: numpy f64 scalars would
            # promote a float32 assembly to float64
            x_d = scale * (float(self._origin[d]) + float(self._spacing[d]) * (base[d][None] + deltas_d))
            comps.append(x_d.expand(nv, T, nx, ny, nzc).reshape(nv, -1))
        return torch.stack(comps, dim=1)

    def _cells_last(self, Ae):
        """(nd, nd, c) element tensors, cells t-major -> the (nd, nd, T, nx,
        ny, nzc) stack whose slices _pack sums."""
        nx, ny, nz_ = self.lat.dims
        nzc = 1 if self.mesh.tdim == 2 else nz_
        nd = Ae.shape[0]
        return Ae.reshape(nd, nd, self.lat.cells_per_box, nx, ny, nzc)

    def _grouped(self, moves):
        grouped = {}
        for t, a, b, m, sh in moves:
            grouped.setdefault((m, sh), []).append((t, a, b))
        return grouped

    def _pack(self, Ae_grid):
        """Accumulate the element tensors' (offset, corner-delta) groups into
        the DIA data (n_off, bs, bs, n0, n1, n2): each group's summed box-grid
        block lands at da + r * box, one strided slice add per (group, ci,
        cj) — the JAX package's lax.pad with interior padding r - 1
        (dolfinx_mpc_tpu/ops/lattice.py:1010-1048)."""
        bs, r3 = self.bs, self.r3
        nb = Ae_grid.shape[3:]
        data = Ae_grid.new_zeros((len(self.offsets), bs, bs) + self.vshape)
        for (oid, da), tab in self._grouped(self.moves).items():
            t, a, b = (torch.as_tensor(v, device=Ae_grid.device) for v in zip(*tab))
            dst = tuple(slice(da[d], da[d] + r3[d] * (nb[d] - 1) + 1, r3[d]) for d in range(3))
            for ci in range(bs):
                for cj in range(bs):
                    data[(oid, ci, cj) + dst] += Ae_grid[a * bs + ci, b * bs + cj, t].sum(0)
        return data

    def _pack_blocked(self, Ae_grid):
        """Blocked analogue of _pack: each (triple, corner-shift) group's
        box-grid block lands on the padded class grids at its shift, no
        stride (dolfinx_mpc_tpu/ops/lattice.py:1395-1409)."""
        nb = Ae_grid.shape[3:]
        data = Ae_grid.new_zeros((len(self.trips),) + self._cdims)
        for (m, sh), tab in self._grouped(self._bmoves).items():
            t, a, b = (torch.as_tensor(v, device=Ae_grid.device) for v in zip(*tab))
            data[m, sh[0]:sh[0] + nb[0], sh[1]:sh[1] + nb[1], sh[2]:sh[2] + nb[2]] += Ae_grid[a, b, t].sum(0)
        return data

    def _fold_operator(self, dia, diagval):
        return LatticeOperator(dia, diagval, self._fold_axis, self._fold_mask, self._fold_pairs,
                               fold_mask_b=self._fold_mask_blocked)

    def _assemble_fold_lean(self, jitter, diagval):
        """Lean fold operator through the element kernel on device-made
        coordinates: the groups packed into the DIA data, Dirichlet rows and
        columns zeroed on the grid, diagval on their diagonal
        (dolfinx_mpc_tpu/ops/lattice.py:1499-1520)."""
        Ae_grid = self._cells_last(self._element_tensors(self._synth_coords(jitter), {}))
        keep = torch.as_tensor(self._keep_grid, device=self.device)
        data = self._diag_adds(self._zero_bc_on_grid(self._pack(Ae_grid), keep), diagval)
        return self._fold_operator(DIAMatrix(data, self.offsets, self.vshape, self.bs), diagval)

    def _assemble_fold_lean_blocked(self, jitter, diagval):
        """_assemble_fold_lean on the parity-blocked layout (scalar degree
        2; dolfinx_mpc_tpu/ops/lattice.py:1455-1478)."""
        Ae_grid = self._cells_last(self._element_tensors(self._synth_coords(jitter), {}))
        keep = torch.as_tensor(self._keep_blocked, device=self.device)
        data = self._diag_adds_blocked(self._zero_bc_blocked(self._pack_blocked(Ae_grid), keep), diagval)
        return self._fold_operator(BlockDIAMatrix(data, self.trips, self.vshape, self.r3), diagval)

    def _assemble_impl(self, diagval):
        """The element kernel on the real cell coordinates, with the
        coefficients gathered per cell: Dirichlet rows and columns masked
        per element, the DIA part packed, diagval on the Dirichlet diagonal,
        then by side format (dolfinx_mpc_tpu/ops/lattice.py:1051-1175):
        fold keeps the slave cells in the stencil and has no side; csr and
        cells leave them out of it and put their K^H A_e K into the side,
        assembled over the slots (csr) or kept per cell (cells)."""
        coeffs = _coeff_vectors(self.term, self.device)
        wl = {n: coeffs[n][dm] for n, dm in self._wdofmaps.items()}
        Ae = self._element_tensors(self._coords, wl)
        keep = self._keep_cells
        Ae.mul_(keep[:, None, :]).mul_(keep[None, :, :])
        if self.side_format == "fold":
            data = self._diag_adds(self._pack(self._cells_last(Ae)), diagval)
            return self._fold_operator(DIAMatrix(data, self.offsets, self.vshape, self.bs), diagval)
        Aep = torch.einsum("ciw,ijc,cjv->cwv", torch.conj(self._Tr), Ae[:, :, self._sc], self._Tr)
        Ae.mul_((1.0 - self._slave_cells)[None, None, :])
        data = self._diag_adds(self._pack(self._cells_last(Ae)), diagval)
        del Ae
        dia = DIAMatrix(data, self.offsets, self.vshape, self.bs)
        N = self.V.num_dofs
        if self.side_format == "cells":
            return LatticeOperator(dia, diagval, side_Aep=Aep, side_er=self._er, slaves=self._slaves)
        vals = torch.cat([Aep.reshape(-1), torch.full((self.n_slaves_diag,), _scalar(diagval, Aep.dtype),
                                                       dtype=Aep.dtype, device=self.device)])
        side = Aep.new_zeros(self.pattern.nnz + 1).index_add_(0, self._slots, vals)[: self.pattern.nnz]
        return LatticeOperator(dia, diagval, side_data=side, side_cols=self._side_cols, side_rows=self._side_rows,
                               side_nrows=N)

    @property
    def bc_dofs(self):
        """The Dirichlet dofs (host int array): the rows and columns the
        operator holds at diagval."""
        return self._bc_dofs_grid

    def assemble(self) -> LatticeOperator:
        if self._route == "kernel":
            return self._assemble_fold_lean_kernel(0.0, self.diagval)
        if self._route == "lean":
            lean = self._assemble_fold_lean_blocked if self._blocked else self._assemble_fold_lean
            return lean(0.0, self.diagval)
        return self._assemble_impl(self.diagval)
