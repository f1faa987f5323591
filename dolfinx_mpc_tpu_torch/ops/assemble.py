"""Constrained assembly (torch): the general slot-CSR matrix assembler,
vector assembly, lifting and set_bc.

Counterpart of ``dolfinx_mpc_tpu/ops/assemble.py``: batched element tensors,
the per-slave-cell ``conj(T)^T A_e T`` (matrices) and ``conj(T)^T b_e``
(vectors) elimination, and an ``index_add_`` into the global CSR data or
vector (the JAX package's ``segment_sum`` / ``.at[].add``).  On the card
``index_add_`` uses atomics, so the summation order of the few
contributions per entry changes from run to run: entries agree with a CPU
run to a few ulps (relative ~1e-6 in float32, ~1e-14 in float64), which is
the tolerance the tests and ``chip_smoke.py`` allow.

The host tables (``_build_cell_transforms``, the slave-cell split and the
slot pattern) are the JAX package's numpy code.  Lattice meshes assemble
through the lattice fast path (ops/lattice.py), whose "csr" and "cells"
side formats reuse these per-cell tables; every other mesh through
``assemble_matrix`` here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .._device import resolve_device
from .._dtypes import numpy_dtype, torch_dtype
from ..fem.forms import Form
from ..fem.functionspace import FunctionSpace
from ..la.sparse import CSRMatrix, SlotPattern, build_slot_pattern
from ..multipointconstraint import MultiPointConstraint
from ..utils.timing import timed
from .kernels import compile_term

__all__ = ["assemble_matrix", "assemble_vector", "apply_lifting", "set_bc",
           "create_sparsity_pattern", "MPCMatrix"]


# ---------------------------------------------------------------------------
# per-cell transformation tables (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------


@dataclass
class CellTransforms:
    """Per-slave-cell elimination data for one (dofmap, mpc) pair.

    slave_cell_mask: (n_cells,) bool
    For the slave cells (in mesh order):
      ext_dofs: (n_sc, W) int64, -1-padded — the cell's dofs followed by the
          masters of its slaves.
      T: (n_sc, nd, W) — local prolongation K_e: identity columns for
          non-slave dofs, coefficient columns for masters; slave columns zero.
    """

    slave_cell_mask: np.ndarray
    cell_pos: np.ndarray  # (n_cells,) position within slave-cell list or -1
    ext_dofs: np.ndarray
    T: np.ndarray


def _build_cell_transforms(V: FunctionSpace, mpc: Optional[MultiPointConstraint], dtype) -> CellTransforms:
    dm = V.dofmap  # (n_cells, nd) unrolled
    n_cells, nd = dm.shape
    if mpc is None or mpc.num_local_slaves == 0:
        return CellTransforms(
            np.zeros(n_cells, bool), -np.ones(n_cells, np.int64), np.zeros((0, nd), np.int64),
            np.zeros((0, nd, nd), dtype)
        )
    is_slave = mpc.is_slave
    slave_pos = -np.ones(V.num_dofs, dtype=np.int64)
    slave_pos[mpc.slaves] = np.arange(mpc.num_local_slaves)
    cell_is_slave = is_slave[dm].any(axis=1)
    sc = np.flatnonzero(cell_is_slave)
    masters_tab = mpc._np_masters
    coeffs_tab = mpc._np_coeffs
    # width: nd + total master slots of slaves in the cell (padded max)
    n_masters_per_slave = (coeffs_tab != 0).sum(axis=1)
    extra = np.array(
        [n_masters_per_slave[slave_pos[dm[c]][slave_pos[dm[c]] >= 0]].sum() for c in sc],
        dtype=np.int64,
    )
    W = nd + (int(extra.max()) if extra.size else 0)
    ext = -np.ones((len(sc), W), dtype=np.int64)
    T = np.zeros((len(sc), nd, W), dtype=dtype)
    for k, c in enumerate(sc):
        dofs = dm[c]
        ext[k, :nd] = dofs
        ptr = nd
        for i, d in enumerate(dofs):
            sp = slave_pos[d]
            if sp < 0:
                T[k, i, i] = 1
            else:
                nm = n_masters_per_slave[sp]
                ext[k, ptr : ptr + nm] = masters_tab[sp, :nm]
                T[k, i, ptr : ptr + nm] = coeffs_tab[sp, :nm]
                ptr += nm
        # slave-dof positions in ext are invalid (-1): their T column is zero,
        # so their global rows/cols receive no contribution
        for i, d in enumerate(dofs):
            if slave_pos[d] >= 0:
                ext[k, i] = -1
    cell_pos = -np.ones(n_cells, dtype=np.int64)
    cell_pos[sc] = np.arange(len(sc))
    return CellTransforms(cell_is_slave, cell_pos, ext, T)


def _mpc_pair(constraint):
    if constraint is None:
        return None, None
    if isinstance(constraint, (list, tuple)):
        return constraint[0], constraint[1]
    return constraint, constraint


def _ext_or_identity(tr: CellTransforms, pos, dm_sub):
    """ext dof rows for cells that are slave on this side, else the plain
    dofs padded to width W."""
    W = tr.ext_dofs.shape[1] if tr.ext_dofs.size else dm_sub.shape[1]
    W = max(W, dm_sub.shape[1])
    out = -np.ones((len(pos), W), dtype=np.int64)
    for k, p in enumerate(pos):
        if p >= 0:
            out[k, : tr.ext_dofs.shape[1]] = tr.ext_dofs[p]
        else:
            out[k, : dm_sub.shape[1]] = dm_sub[k]
    return out


def _T_or_identity(tr: CellTransforms, pos, nd, W, dtype):
    out = np.zeros((len(pos), nd, W), dtype=dtype)
    eye = np.eye(nd, dtype=dtype)
    for k, p in enumerate(pos):
        if p >= 0:
            out[k, :, : tr.T.shape[2]] = tr.T[p]
        else:
            out[k, :, :nd] = eye
    return out


def _real_dtype(dtype):
    dt = np.dtype(dtype)
    return np.float32 if dt in (np.dtype(np.float32), np.dtype(np.complex64)) else np.float64


def _bc_applies(bc, V) -> bool:
    """Does this bc act on V?  bcs on other spaces are ignored."""
    if bc.V is V or getattr(bc.V, "mixed_parent", None) is V:
        return True
    return (
        bc.V.num_dofs == V.num_dofs
        and bc.V.mesh is V.mesh
        and getattr(bc.V, "dof_offset", 0) == getattr(V, "dof_offset", 0)
        and getattr(bc.V, "block_size", 1) == getattr(V, "block_size", 1)
        and getattr(getattr(bc.V, "element", None), "degree", None)
        == getattr(getattr(V, "element", None), "degree", None)
    )


def _bc_masks(V: FunctionSpace, bcs, dtype):
    """BC row/col indicator (host numpy); bcs on other spaces are ignored."""
    mask = np.zeros(V.num_dofs, dtype=_real_dtype(dtype))
    for bc in bcs:
        if _bc_applies(bc, V):
            mask[bc.dofs] = 1.0
    return mask


def _bc_values(V: FunctionSpace, bcs, dtype):
    g = np.zeros(V.num_dofs, dtype=dtype)
    for bc in bcs:
        if _bc_applies(bc, V):
            g[bc.dofs] = bc.dof_values(dtype)
    return g


def _form_cache(form) -> dict:
    """Compiled-table cache attached to the Form itself; keys hold the
    constraint object, so its lifetime is pinned and identity is safe."""
    return form.__dict__.setdefault("_compiled_cache", {})


def _coeff_vectors(term, device):
    return {n: f.x.array.to(device) for n, f in term.coefficients.items()}


def _resolve(constraint, dtype, device, like=None):
    """dtype and device of an assembly: the caller's, else the constraint's,
    else those of the tensor `like`, else float64 on the card."""
    mpc_r, _ = _mpc_pair(constraint)
    if dtype is None:
        if mpc_r is not None:
            dtype = mpc_r.dtype
        else:
            dtype = numpy_dtype(like.dtype) if isinstance(like, torch.Tensor) else np.float64
    if device is None:
        if mpc_r is not None:
            device = mpc_r.device
        elif isinstance(like, torch.Tensor):
            device = like.device
    return np.dtype(dtype), resolve_device(device)


# ---------------------------------------------------------------------------
# matrices: the general slot-CSR assembler
# ---------------------------------------------------------------------------


# cells per chunk of the matrix assembly: bounds the per-quadrature kernel
# intermediates, O(chunk * nq * nd^2) (the JAX package's cell_chunk)
CELL_CHUNK = 262144


@dataclass
class CompiledMatrixForm:
    terms: list  # CompiledTerm
    pattern: SlotPattern
    tables: list  # per term: {"ns": ..., "sl": ...} dicts of device tensors
    slots: list  # per scatter block: int64 device tensor of CSR slots
    slaves_row: np.ndarray
    n_diag: int  # number of bc-diagonal passthrough entries (0 if not square)


def _side_tables(ct, Vt, Vs, cells, order, Tr, Tc, dtype, device):
    """Device tables of one class (non-slave or slave cells) of one term."""
    mesh = Vt.mesh
    c = cells[order]
    as_t = lambda a, dt=torch.int64: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    tb = dict(
        coords=as_t(mesh.points[mesh.cells[c]], torch_dtype(_real_dtype(dtype))),
        lf=as_t(ct.local_facets[order]),
        dmr=as_t(Vt.dofmap[c]),
        dmc=as_t(Vs.dofmap[c]),
        wdofmaps={n: as_t(W.dofmap[c]) for n, W in zip(ct.coeff_names, ct.coeff_spaces)},
    )
    if Tr is not None:
        tb["Tr"] = as_t(Tr, torch_dtype(dtype))
        tb["Tc"] = as_t(Tc, torch_dtype(dtype))
    return tb


def _compile_matrix(form: Form, constraint, dtype, device) -> CompiledMatrixForm:
    """Compile the constrained matrix assembly: the host slot pattern (the
    JAX package's batches, in its order) and the device tables.  Cells of
    each term split into non-slave and slave classes, whose values
    assemble_matrix computes CELL_CHUNK cells at a time."""
    mpc_r, mpc_c = _mpc_pair(constraint)
    Vt, Vs = form.test_space, form.trial_space
    tr_row = _build_cell_transforms(Vt, mpc_r, dtype)
    tr_col = _build_cell_transforms(Vs, mpc_c, dtype)
    terms = [compile_term(t, Vt, Vs) for t in form.terms]
    batches, masks, tables = [], [], []
    for ct in terms:
        cells = ct.cells
        sl = tr_row.slave_cell_mask[cells] | tr_col.slave_cell_mask[cells]
        idx_ns = np.flatnonzero(~sl)
        idx_sl = np.flatnonzero(sl)
        dmr = Vt.dofmap[cells]
        dmc = Vs.dofmap[cells]
        # non-slave batch
        r_ns = np.broadcast_to(dmr[idx_ns][:, :, None], (len(idx_ns), dmr.shape[1], dmc.shape[1]))
        c_ns = np.broadcast_to(dmc[idx_ns][:, None, :], r_ns.shape)
        batches.append((r_ns, c_ns))
        masks.append(None)
        # slave batch: ext_row x ext_col (cells slave only on one side use
        # their own dofs on the other)
        pr = tr_row.cell_pos[cells[idx_sl]]
        pc = tr_col.cell_pos[cells[idx_sl]]
        er = _ext_or_identity(tr_row, pr, dmr[idx_sl])
        ecol = _ext_or_identity(tr_col, pc, dmc[idx_sl])
        r_sl = np.broadcast_to(er[:, :, None], (len(idx_sl), er.shape[1], ecol.shape[1]))
        c_sl = np.broadcast_to(ecol[:, None, :], r_sl.shape)
        batches.append((r_sl, c_sl))
        masks.append((r_sl >= 0) & (c_sl >= 0))
        Tr = _T_or_identity(tr_row, pr, dmr.shape[1], er.shape[1], dtype)
        Tc = _T_or_identity(tr_col, pc, dmc.shape[1], ecol.shape[1], dtype)
        tables.append(dict(ns=_side_tables(ct, Vt, Vs, cells, idx_ns, None, None, dtype, device),
                           sl=_side_tables(ct, Vt, Vs, cells, idx_sl, Tr, Tc, dtype, device)))
    # slave diagonal + bc diagonal slots (square forms only)
    square = Vt.num_dofs == Vs.num_dofs
    slaves_row = (mpc_r.slaves if (square and mpc_r is not None and mpc_r.num_local_slaves)
                  else np.zeros(0, np.int64))
    batches.append((slaves_row, slaves_row))
    masks.append(None)
    all_dofs = np.arange(Vt.num_dofs if square else 0, dtype=np.int64)
    batches.append((all_dofs, all_dofs))  # bc diagonal: every diagonal entry available
    masks.append(None)
    pattern = build_slot_pattern((Vt.num_dofs, Vs.num_dofs), batches, masks)
    slots = [torch.as_tensor(s.astype(np.int64), device=device) for s in pattern.slots]
    return CompiledMatrixForm(terms, pattern, tables, slots, slaves_row, len(all_dofs))


def _class_values(ct, tb, coeffs, bc_row, bc_col, lo, hi, tdt):
    """Flat element values of cells [lo, hi) of one class: Ae masked by the
    bc rows and columns, then conj(Tr)^T Ae Tc on the slave class."""
    wl = {n: coeffs[n][tb["wdofmaps"][n][lo:hi]] for n in coeffs}
    Ae = ct.kernel(tb["coords"][lo:hi], tb["lf"][lo:hi], wl).to(tdt)  # (chunk, ndt, nds)
    mr = 1.0 - bc_row[tb["dmr"][lo:hi]]
    mc = 1.0 - bc_col[tb["dmc"][lo:hi]]
    Ae = Ae * mr[:, :, None] * mc[:, None, :]
    if "Tr" in tb:
        Ae = torch.einsum("ciw,cij,cjv->cwv", torch.conj(tb["Tr"][lo:hi]), Ae, tb["Tc"][lo:hi])
    return Ae.reshape(-1)


class MPCMatrix(CSRMatrix):
    """Assembled constrained matrix: CSR with the K^H A K structure plus
    diagval on slave and bc diagonals."""


def _get_compiled_matrix(form, constraint, dtype, device):
    key = ("mat", constraint if not isinstance(constraint, list) else tuple(constraint),
           dtype.str, str(device))
    cache = _form_cache(form)
    cm = cache.get(key)
    if cm is None:
        cm = cache[key] = _compile_matrix(form, constraint, dtype, device)
    return cm


def assemble_matrix(form: Form, constraint=None, bcs=None, diagval=1.0, dtype=None, device=None) -> MPCMatrix:
    """Assemble a bilinear form with MPC elimination and Dirichlet handling
    into slot CSR, in the span "~MPC: Assemble matrix".  `constraint` may
    be one MPC or a pair (row, col) for rectangular assembly.  dtype and
    device default to the constraint's (float64 on the card without one)."""
    with timed("~MPC: Assemble matrix"):
        return _assemble_matrix(form, constraint, bcs or [], diagval, dtype, device)


def _assemble_matrix(form, constraint, bcs, diagval, dtype, device):
    dtype, device = _resolve(constraint, dtype, device)
    cm = _get_compiled_matrix(form, constraint, dtype, device)
    Vt, Vs = form.test_space, form.trial_space
    bc_row = torch.as_tensor(_bc_masks(Vt, bcs, dtype), device=device)
    bc_col = torch.as_tensor(_bc_masks(Vs, bcs, dtype), device=device) if Vs is not Vt else bc_row
    bc_diag = np.zeros(cm.n_diag, dtype=dtype)
    if cm.n_diag:
        for bc in bcs:
            bc_diag[bc.dofs] = diagval
    data = _matrix_values(cm, bc_row, bc_col, torch.as_tensor(bc_diag, device=device), diagval,
                          torch_dtype(dtype))
    return MPCMatrix.from_pattern(cm.pattern, data)


def _matrix_values(cm, bc_row, bc_col, bc_diag, diagval, tdt):
    """The slot-CSR values of a compiled matrix form on bc_row's device: every
    term's cell classes CELL_CHUNK cells at a time (masked by the bc rows and
    columns), diagval on the slave diagonals, bc_diag (n_diag values) on the
    diagonal."""
    device = bc_row.device
    nnz = cm.pattern.nnz
    data = torch.zeros(nnz + 1, dtype=tdt, device=device)  # slot nnz: trash
    blocks = iter(cm.slots)
    for ct, tb in zip(cm.terms, cm.tables):
        coeffs = _coeff_vectors(ct.term, device)
        for side in ("ns", "sl"):
            t = tb[side]
            slots = next(blocks)
            n_cells = t["coords"].shape[0]
            width = slots.shape[0] // max(n_cells, 1)
            for lo in range(0, n_cells, CELL_CHUNK):
                hi = min(lo + CELL_CHUNK, n_cells)
                vals = _class_values(ct, t, coeffs, bc_row, bc_col, lo, hi, tdt)
                data.index_add_(0, slots[lo * width:hi * width], vals)
    # diagval on the slave diagonals, then the bc-diagonal passthrough
    dv = diagval.real if (isinstance(diagval, complex) and not tdt.is_complex) else diagval
    data.index_add_(0, next(blocks), torch.full((len(cm.slaves_row),), dv, dtype=tdt, device=device))
    data.index_add_(0, next(blocks), bc_diag)
    return data[:nnz]


def create_sparsity_pattern(form: Form, mpc, device=None) -> SlotPattern:
    """The slot-CSR pattern of the constrained form (the JAX package's
    create_sparsity_pattern)."""
    dtype, device = _resolve(mpc, None, device)
    return _get_compiled_matrix(form, mpc, dtype, device).pattern


# ---------------------------------------------------------------------------
# vectors
# ---------------------------------------------------------------------------


@dataclass
class CompiledVectorForm:
    terms: list  # CompiledTerm
    tables: list  # per term: dict of device tensors


def _term_tables(ct, Vt, tr_row, cells, lf, dtype, device):
    """Device tables of one term over `cells` (with their local facets
    `lf`): coordinates, the slave / non-slave split, the local
    prolongations and the scatter targets (invalid -1 -> trash slot
    ndofs)."""
    mesh = Vt.mesh
    ndofs = Vt.num_dofs
    sl = tr_row.slave_cell_mask[cells]
    idx_ns = np.flatnonzero(~sl)
    idx_sl = np.flatnonzero(sl)
    dmr = Vt.dofmap[cells]
    pr = tr_row.cell_pos[cells[idx_sl]]
    er = _ext_or_identity(tr_row, pr, dmr[idx_sl])
    Tr = _T_or_identity(tr_row, pr, dmr.shape[1], er.shape[1], dtype)
    as_t = lambda a, dt=torch.int64: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
    return dict(
        coords=as_t(mesh.points[mesh.cells[cells]], torch_dtype(_real_dtype(dtype))),
        lf=as_t(lf),
        idx_ns=as_t(idx_ns),
        idx_sl=as_t(idx_sl),
        Tr=as_t(Tr, torch_dtype(dtype)),
        dmr=as_t(dmr),
        tgt_ns=as_t(dmr[idx_ns].reshape(-1)),
        tgt_sl=as_t(np.where(er >= 0, er, ndofs).reshape(-1)),
        wdofmaps={n: as_t(W.dofmap[cells]) for n, W in zip(ct.coeff_names, ct.coeff_spaces)},
    )


def _compile_vector(form: Form, constraint, dtype, device) -> CompiledVectorForm:
    mpc_r, _ = _mpc_pair(constraint)
    Vt = form.test_space
    tr_row = _build_cell_transforms(Vt, mpc_r, dtype)
    terms = [compile_term(t, Vt, None) for t in form.terms]
    tables = [_term_tables(ct, Vt, tr_row, ct.cells, ct.local_facets, dtype, device) for ct in terms]
    return CompiledVectorForm(terms, tables)


def _scatter(b, tb, be):
    """b[tgt] += be for non-slave cells; b[ext] += conj(T)^T be for slave
    cells (b carries one trash slot at the end)."""
    be_sl = be[tb["idx_sl"]]
    bep = torch.einsum("ciw,ci->cw", torch.conj(tb["Tr"]), be_sl)
    b.index_add_(0, tb["tgt_ns"], be[tb["idx_ns"]].reshape(-1))
    b.index_add_(0, tb["tgt_sl"], bep.reshape(-1))


def assemble_vector(form: Form, constraint=None, b=None, dtype=None, device=None):
    """Assemble a linear form with the K^H b MPC redistribution, in the span
    "~MPC: Assemble vector".  dtype and device default to the constraint's
    (float64 on the card without one)."""
    dtype, device = _resolve(constraint, dtype, device)
    with timed("~MPC: Assemble vector"):
        key = ("vec", constraint, dtype.str, str(device))
        cache = _form_cache(form)
        cv = cache.get(key)
        if cv is None:
            cv = cache[key] = _compile_vector(form, constraint, dtype, device)
        ndofs = form.test_space.num_dofs
        out = torch.zeros(ndofs + 1, dtype=torch_dtype(dtype), device=device)
        for ct, tb in zip(cv.terms, cv.tables):
            coeffs = _coeff_vectors(ct.term, device)
            wlocals = {n: coeffs[n][tb["wdofmaps"][n]] for n in coeffs}
            be = ct.kernel(tb["coords"], tb["lf"], wlocals).to(out.dtype)  # (n_ent, ndt)
            _scatter(out, tb, be)
        out = out[:ndofs]
    return out if b is None else b + out


# ---------------------------------------------------------------------------
# lifting + set_bc
# ---------------------------------------------------------------------------


def _compile_lifting(form: Form, constraint, dtype, device, bcs):
    """Per-cell: be = -Ae @ g_cell (raw Ae, no bc zeroing), then
    conj(T)^T be.  Only cells with at least one BC COLUMN dof are processed
    (the reference's entity skip), so the tables are O(bc surface)."""
    mpc_r, _ = _mpc_pair(constraint)
    Vt, Vs = form.test_space, form.trial_space
    tr_row = _build_cell_transforms(Vt, mpc_r, dtype)
    terms = [compile_term(t, Vt, Vs) for t in form.terms]
    bc_col = np.zeros(Vs.num_dofs, bool)
    for bc in bcs:
        if _bc_applies(bc, Vs):
            bc_col[bc.dofs] = True
    tables = []
    for ct in terms:
        keep = np.flatnonzero(bc_col[Vs.dofmap[ct.cells]].any(axis=1))
        cells = ct.cells[keep]
        tb = _term_tables(ct, Vt, tr_row, cells, ct.local_facets[keep], dtype, device)
        tb["dmc"] = torch.as_tensor(Vs.dofmap[cells], dtype=torch.int64, device=device)
        tables.append(tb)
    return terms, tables


def apply_lifting(b, forms, bcs_list, constraint=None, x0=None, scale=1.0, dtype=None, device=None):
    """b <- b - scale * K^H A (g - x0).  `forms` is a list of bilinear forms,
    `bcs_list` a list of bc-lists (one per form).  dtype and device default
    to the constraint's, else to b's."""
    dtype, device = _resolve(constraint, dtype, device, like=b)
    tdt = torch_dtype(dtype)
    b = torch.as_tensor(b, dtype=tdt, device=device)
    for form, bcs in zip(forms, bcs_list):
        if not bcs:
            continue
        # DirichletBC is an unhashable dataclass: key on ids and pin the bcs
        key = ("lift", constraint, dtype.str, str(device), tuple(id(bc) for bc in bcs))
        cache = _form_cache(form)
        if key not in cache:
            cache[key] = (_compile_lifting(form, constraint, dtype, device, bcs), tuple(bcs))
        (terms, tables), _ = cache[key]
        Vs = form.trial_space
        gvec = torch.as_tensor(_bc_values(Vs, bcs, dtype), device=device)
        bc_col = torch.as_tensor(_bc_masks(Vs, bcs, dtype), device=device).to(tdt)
        if x0 is not None:
            gvec = gvec - torch.as_tensor(x0, dtype=tdt, device=device)
        lift = torch.zeros(form.test_space.num_dofs + 1, dtype=tdt, device=device)
        for ct, tb in zip(terms, tables):
            coeffs = _coeff_vectors(ct.term, device)
            wlocals = {n: coeffs[n][tb["wdofmaps"][n]] for n in coeffs}
            Ae = ct.kernel(tb["coords"], tb["lf"], wlocals).to(tdt)
            gcell = gvec[tb["dmc"]] * bc_col[tb["dmc"]]
            be = -scale * torch.einsum("cij,cj->ci", Ae, gcell)
            _scatter(lift, tb, be)
        b = b + lift[:-1]
    return b


def set_bc(b, bcs, x0=None, scale=1.0):
    """b[bc] = scale * (g - x0)[bc]; returns a new tensor."""
    if not bcs:
        return b
    V = bcs[0].V
    g = torch.as_tensor(_bc_values(V, bcs, numpy_dtype(b.dtype)), device=b.device)
    dofs = torch.as_tensor(np.concatenate([bc.dofs for bc in bcs]), device=b.device)
    gd = g[dofs]
    if x0 is not None:
        gd = gd - torch.as_tensor(x0, dtype=b.dtype, device=b.device)[dofs]
    out = b.clone()
    out[dofs] = scale * gd
    return out
