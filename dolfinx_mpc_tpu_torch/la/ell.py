"""Block-ELL sparse format for unstructured vector (and scalar) operators
(torch).

Counterpart of ``dolfinx_mpc_tpu/la/ell.py``.  FEM matrices from vector
spaces are node-block matrices with a tight degree distribution, so each
block row is padded to a fixed K neighbour blocks:

    data: (nbr, K, br, bc)   dense blocks (zero-padded slots)
    cols: (nbr, K) int64     block-column indices (padded slots -> 0)

and the matvec is gather + broadcast-multiply-sum, plus an ``index_add_``
for the COO remainder of rows denser than K:

    y[n, i] = sum_k sum_j data[n, k, i, j] * x[cols[n, k], j]

The conversion is the JAX package's numpy code, copied.  The JAX package
has no Pallas kernel for this format, so the matvec is plain torch on every
device (the AMG levels of the card path use it).
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device

__all__ = ["BlockEllMatrix", "ell_from_scipy"]


class BlockEllMatrix:
    """data: (nbr, K, br, bc) node blocks; cols: (nbr, K) block-column ids
    (padded slots point at block-col 0 with zero data); diag: (n,) stored
    at conversion; rem_*: COO overflow for rows denser than K."""

    def __init__(self, data, cols, diag, rem_data, rem_rows, rem_cols, shape):
        self.data = data
        self.cols = cols
        self.diag = diag
        self.rem_data = rem_data
        self.rem_rows = rem_rows
        self.rem_cols = rem_cols
        self.shape = tuple(shape)

    @property
    def br(self):
        return self.data.shape[2]

    @property
    def bc(self):
        return self.data.shape[3]

    @property
    def nnz_stored(self):
        return int(np.prod(self.data.shape)) + int(self.rem_data.shape[0])

    def matvec(self, x):
        n_rows, n_cols = self.shape
        nbr, K, br, bc = self.data.shape
        nbc = -(-n_cols // bc)
        xp = torch.nn.functional.pad(x, (0, nbc * bc - n_cols)).reshape(nbc, bc)
        xg = xp[self.cols]  # (nbr, K, bc) gather of whole node vectors
        y = (self.data * xg[:, :, None, :]).sum(dim=(1, 3))  # (nbr, br)
        y = y.reshape(-1)[:n_rows]
        if self.rem_data.shape[0]:
            y = y.index_add(0, self.rem_rows, self.rem_data * x[self.rem_cols])
        return y

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        return self.diag

    def to_scipy(self):
        import scipy.sparse as sp

        nbr, K, br, bc = self.data.shape
        n_rows, n_cols = self.shape
        data = self.data.cpu().numpy()
        cols = self.cols.cpu().numpy()
        rr = (np.arange(nbr)[:, None, None, None] * br
              + np.arange(br)[None, None, :, None])
        cc = (cols[:, :, None, None] * bc + np.arange(bc)[None, None, None, :])
        rr, cc = np.broadcast_to(rr, data.shape), np.broadcast_to(cc, data.shape)
        keep = (rr < n_rows) & (cc < n_cols)
        A = sp.coo_matrix((data[keep], (rr[keep], cc[keep])), shape=self.shape)
        if self.rem_data.shape[0]:
            A = A + sp.coo_matrix(
                (self.rem_data.cpu().numpy(),
                 (self.rem_rows.cpu().numpy(), self.rem_cols.cpu().numpy())),
                shape=self.shape)
        A = sp.csr_matrix(A)
        A.eliminate_zeros()
        return A


def ell_arrays_from_scipy(A, br=1, bc=None, k_cap=None, k_quantile=100.0, dtype=np.float32):
    """The host arrays (data, cols, diag, rem_data, rem_rows, rem_cols,
    shape) of the block-ELL form of a scipy sparse matrix: the JAX
    package's conversion, copied."""
    import scipy.sparse as sp

    bc = br if bc is None else bc
    diag = np.asarray(sp.csr_matrix(A).diagonal(), dtype=dtype)
    A = sp.coo_matrix(A)
    A.sum_duplicates()
    n_rows, n_cols = A.shape
    nbr = -(-n_rows // br)
    nbc = -(-n_cols // bc)
    row = A.row.astype(np.int64)
    col = A.col.astype(np.int64)
    val = A.data.astype(dtype)
    brow = row // br
    bcol = col // bc
    key = brow * nbc + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    ub = uniq // nbc
    ucol = (uniq % nbc).astype(np.int32)
    counts = np.bincount(ub, minlength=nbr)
    K = int(counts.max()) if counts.size and counts.max() > 0 else 1
    if k_cap is not None:
        K = min(K, int(k_cap))
    elif k_quantile < 100.0 and (counts > 0).any():
        K = min(K, max(int(np.percentile(counts[counts > 0], k_quantile)), 1))
    K = max(K, 1)
    # rank of each unique block within its row (uniq is (brow, bcol)-sorted)
    first = np.searchsorted(ub, np.arange(nbr))
    slot_u = np.arange(len(uniq)) - first[ub]
    keep_u = slot_u < K
    cols = np.zeros((nbr, K), dtype=np.int32)
    cols[ub[keep_u], slot_u[keep_u]] = ucol[keep_u]

    keep_e = keep_u[inv]
    slot_e = slot_u[inv]
    lin = (((brow[keep_e] * K + slot_e[keep_e]) * br + row[keep_e] % br) * bc
           + col[keep_e] % bc)
    size = nbr * K * br * bc
    if np.iscomplexobj(val):
        data = (np.bincount(lin, weights=val[keep_e].real, minlength=size)
                + 1j * np.bincount(lin, weights=val[keep_e].imag,
                                   minlength=size)).astype(dtype)
    else:
        data = np.bincount(lin, weights=val[keep_e].astype(np.float64),
                           minlength=size).astype(dtype)
    data = data.reshape(nbr, K, br, bc)

    ov = ~keep_e
    order = np.argsort(row[ov], kind="stable")
    rem_rows = row[ov][order].astype(np.int32)
    rem_cols = col[ov][order].astype(np.int32)
    rem_data = val[ov][order]
    return data, cols, diag, rem_data, rem_rows, rem_cols, (n_rows, n_cols)


def ell_from_arrays(data, cols, diag, rem_data, rem_rows, rem_cols, shape, device=DEFAULT_DEVICE):
    """BlockEllMatrix on `device` from its host arrays (index arrays as
    int64, the gather and scatter index type)."""
    dev = resolve_device(device)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)  # noqa: E731
    return BlockEllMatrix(f(data), i(cols), f(diag), f(rem_data), i(rem_rows), i(rem_cols), shape)


def ell_from_scipy(A, br=1, bc=None, k_cap=None, k_quantile=100.0, dtype=np.float32,
                   device=DEFAULT_DEVICE) -> BlockEllMatrix:
    """Convert a scipy sparse matrix to block-ELL with br x bc blocks.

    K (blocks per block-row) is min(max needed, `k_cap` or the `k_quantile`
    percentile of per-row block counts); spilled blocks land in the COO
    remainder.  Rows/cols need not divide br/bc (trailing partial block is
    zero-padded)."""
    dev = resolve_device(device)
    return ell_from_arrays(*ell_arrays_from_scipy(A, br, bc, k_cap, k_quantile, dtype), device=dev)
