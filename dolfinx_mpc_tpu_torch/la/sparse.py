"""Sparse matrices: slot-based CSR built from static sparsity patterns (torch).

Counterpart of ``dolfinx_mpc_tpu/la/sparse.py``.  The sparsity is computed
once on the host and each scattered element entry gets a precomputed *slot*
into the CSR data array (entry slot ``nnz`` is a trash slot for padded
entries); assembly is then one ``index_add_`` per block of entries.  The
pattern code is the JAX package's numpy, copied.  ``CSRMatrix.matvec`` and
``diagonal`` are gathers plus ``index_add_`` over ``row_ids``, the
counterpart of the JAX package's ``segment_sum`` (on the card the row sums
use atomics, so their order changes from run to run).  There is no TPU
kernel here, so there is none on the card either.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device

__all__ = ["SlotPattern", "CSRMatrix", "build_slot_pattern", "csr_from_scipy"]


@dataclass
class SlotPattern:
    """Static CSR sparsity + per-scattered-entry slot map.

    indptr: (n_rows+1,), indices: (nnz,) — CSR structure.
    slots: list of int32 arrays, one per scatter batch registered at build
    time, mapping each flattened (row, col) entry to its CSR slot (or nnz for
    padded/invalid entries).
    """

    shape: tuple
    indptr: np.ndarray
    indices: np.ndarray
    slots: list
    row_ids: np.ndarray  # (nnz,) row of each stored entry — for SpMV

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]


def build_slot_pattern(shape, batches, valid_masks=None) -> SlotPattern:
    """Build CSR + slots from scatter batches.

    batches: list of (rows, cols) int arrays of equal shape (flattened
    internally).  valid_masks: optional per-batch bool arrays; invalid entries
    map to the trash slot.
    """
    n_rows, n_cols = shape
    flat = []
    for bi, (r, c) in enumerate(batches):
        r = np.asarray(r).ravel().astype(np.int64)
        c = np.asarray(c).ravel().astype(np.int64)
        if valid_masks is not None and valid_masks[bi] is not None:
            m = np.asarray(valid_masks[bi]).ravel()
            r = np.where(m, r, -1)
            c = np.where(m, c, -1)
        flat.append((r, c))
    all_r = np.concatenate([f[0] for f in flat])
    all_c = np.concatenate([f[1] for f in flat])
    valid = (all_r >= 0) & (all_c >= 0)
    keys = all_r * n_cols + all_c
    uniq = np.unique(keys[valid])
    rows_u = uniq // n_cols
    cols_u = uniq % n_cols
    nnz = uniq.shape[0]
    counts = np.bincount(rows_u, minlength=n_rows)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # uniq is sorted by key = row-major => indices already CSR-ordered
    indices = cols_u.astype(np.int32)
    slot_all = np.full(keys.shape, nnz, dtype=np.int64)
    slot_all[valid] = np.searchsorted(uniq, keys[valid])
    slots = []
    off = 0
    for r, _ in flat:
        slots.append(slot_all[off : off + r.shape[0]].astype(np.int32))
        off += r.shape[0]
    return SlotPattern((n_rows, n_cols), indptr, indices, slots, rows_u.astype(np.int32))


class CSRMatrix:
    """CSR matrix with static structure on one device: data (nnz,),
    indices / row_ids (nnz,) int64 (the gather and scatter indices),
    indptr (n_rows+1,) int64."""

    def __init__(self, data, indices, indptr, row_ids, shape):
        self.data = data
        self.indices = indices
        self.indptr = indptr
        self.row_ids = row_ids
        self.shape = tuple(shape)

    @classmethod
    def from_pattern(cls, pattern: SlotPattern, data):
        dev = data.device
        as_i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
        return cls(data, as_i(pattern.indices), as_i(pattern.indptr), as_i(pattern.row_ids), pattern.shape)

    @property
    def device(self):
        return self.data.device

    def matvec(self, x):
        prod = self.data * x[self.indices]
        y = torch.zeros(self.shape[0], dtype=prod.dtype, device=prod.device)
        return y.index_add_(0, self.row_ids, prod)

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        on_diag = torch.where(self.row_ids == self.indices, self.data, torch.zeros_like(self.data))
        d = torch.zeros(self.shape[0], dtype=self.data.dtype, device=self.data.device)
        return d.index_add_(0, self.row_ids, on_diag)

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix(
            (self.data.cpu().numpy(), self.indices.cpu().numpy(), self.indptr.cpu().numpy()),
            shape=self.shape)

    def to_dense(self):
        return np.asarray(self.to_scipy().todense())

    def to_bell(self, **kw):
        """Convert to the blocked-ELL format (la/bell.py), on this matrix's
        device unless `device` is given."""
        from .bell import bell_from_scipy

        kw.setdefault("device", self.device)
        return bell_from_scipy(self.to_scipy(), **kw)


def csr_from_scipy(A, dtype=None, device=DEFAULT_DEVICE) -> CSRMatrix:
    """CSRMatrix of a scipy sparse matrix (its dtype unless `dtype`)."""
    A = A.tocsr()
    dev = resolve_device(device)
    data = A.data if dtype is None else A.data.astype(dtype)
    row_ids = np.repeat(np.arange(A.shape[0], dtype=np.int64), np.diff(A.indptr))
    as_i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    return CSRMatrix(torch.as_tensor(np.ascontiguousarray(data), device=dev), as_i(A.indices),
                     as_i(A.indptr), as_i(row_ids), A.shape)
