"""Blocked-ELL (BELL) sparse matrix and its SpMV kernel K8 (torch + CUDA).

Counterpart of ``dolfinx_mpc_tpu/la/bell.py``.  Rows are grouped into
blocks of R=8, columns into aligned tiles of C=128, and every (row block,
column tile) pair holding a nonzero stores a dense (R, C) tile:

    y[b*R + r] = sum_t  data[b, t, r, :] . x[cols[b, t]*C : +C]

Rows denser than the ``mt`` tile budget (MPC slave rows coupling to
far-away masters) spill their overflow nonzeros to a COO remainder, added
with one ``index_add_``, outside the kernel as in the JAX package.

- **K8** ``bell_matvec`` replaces the TPU kernel ``_bell_matvec_pallas``
  (``dolfinx_mpc_tpu/la/bell.py:147-189``).  Its CUDA source is
  ``csrc/bell_kernels.cu``; every ``BellMatrix.matvec`` on a CUDA tensor
  launches it, at any size, in float32 and float64, or raises.
- ``bell_matvec_plain`` is the JAX package's XLA path (gather of x tiles,
  multiply, sum over (t, C)); CPU tensors run it.

The conversion ``bell_from_scipy`` is the JAX package's numpy code, copied.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device

__all__ = ["BellMatrix", "bell_from_scipy", "bell_matvec", "bell_matvec_plain"]

_FLOATS = (torch.float32, torch.float64)


def declare_signatures(lib: ctypes.CDLL) -> None:
    """ctypes argtypes/restype of the launchers in csrc/bell_kernels.cu."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for suf in ("f32", "f64"):
        fn = getattr(lib, f"dmt_bell_matvec_{suf}")
        fn.argtypes = [P, P, P, P, I, I, L, L, P]
        fn.restype = I


def bell_matvec_plain(data, cols, x, n_rows=None):
    """Plain PyTorch BELL SpMV (the JAX package's XLA path, la/bell.py:
    110-111): x zero-padded to whole tiles, the tiles of each block gathered
    by cols, multiplied and summed over (t, C).  data (nblk, mt, R, C), cols
    (nblk, mt), x (n_cols,); returns the first n_rows (default nblk*R) rows."""
    nblk, mt, R, C = data.shape
    n = x.shape[0]
    ntc = -(-n // C)
    x2 = torch.nn.functional.pad(x, (0, ntc * C - n)).reshape(ntc, C)
    xg = x2[cols.long()]  # (nblk, mt, C)
    y = (data * xg[:, :, None, :]).sum(dim=(1, 3)).reshape(-1)
    return y if n_rows is None else y[:n_rows]


def bell_matvec(data, cols, x, n_rows=None):
    """K8: the BELL SpMV on the card, y[b*R + r] = sum_t data[b, t, r, :] .
    x[cols[b, t]*C : +C] for the first n_rows (default nblk*R) rows; data
    (nblk, mt, 8, 128) float32 or float64, cols (nblk, mt) int32, x
    (n_cols,) of data's type.

    Replaces the TPU kernel dolfinx_mpc_tpu/la/bell.py:_bell_matvec_pallas
    (f32 only there, x at most 8 MiB).  One block of 128 threads per row
    block, each thread one lane of every tile with 8 row sums in registers,
    then a reduction over the lanes (csrc/bell_kernels.cu).  Bound by
    device memory: the tiles are streamed once, nblk*mt*R*C values.  CPU
    tensors run the plain version."""
    nblk, mt, R, C = data.shape
    n_rows = nblk * R if n_rows is None else int(n_rows)
    if data.device.type == "cpu" and x.device.type == "cpu":
        return bell_matvec_plain(data, cols, x, n_rows)
    if data.device.type != "cuda" or x.device != data.device or cols.device != data.device:
        raise RuntimeError(f"bell_matvec: data on {data.device}, cols on {cols.device}, x on {x.device}")
    if data.dtype not in _FLOATS or x.dtype != data.dtype:
        raise TypeError(f"bell_matvec: data {data.dtype}, x {x.dtype} (need equal float32/float64)")
    if (R, C) != (8, 128):
        raise ValueError(f"bell_matvec: tiles ({R}, {C}); the kernel is built for R=8, C=128")
    if cols.dtype != torch.int32 or tuple(cols.shape) != (nblk, mt):
        raise ValueError(f"bell_matvec: cols {cols.dtype} {tuple(cols.shape)}, need int32 ({nblk}, {mt})")
    if not (data.is_contiguous() and cols.is_contiguous() and x.is_contiguous()) or x.dim() != 1:
        raise ValueError("bell_matvec: data, cols and x must be contiguous, x flat")
    if n_rows > nblk * R:
        raise ValueError(f"bell_matvec: n_rows {n_rows} > {nblk} blocks of {R}")
    from .._build import load_kernels
    from ..ops.lattice_kernels import _launch_check

    lib = load_kernels()
    y = torch.empty(n_rows, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(lib, f"dmt_bell_matvec_{'f32' if x.dtype == torch.float32 else 'f64'}")(
            data.data_ptr(), cols.data_ptr(), x.data_ptr(), y.data_ptr(), nblk, mt, n_rows, x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _launch_check(rc, "bell_matvec")
    bell_matvec.launches += 1
    return y


bell_matvec.launches = 0


class BellMatrix:
    """data: (nblk, mt, R, C) dense tiles; cols: (nblk, mt) int32 column
    TILE indices (padded slots point at tile 0 with zero data); diag: (n,)
    stored at conversion; rem_*: COO overflow (rows and columns int64)."""

    def __init__(self, data, cols, diag, rem_data, rem_rows, rem_cols, shape):
        self.data = data
        self.cols = cols
        self.diag = diag
        self.rem_data = rem_data
        self.rem_rows = rem_rows
        self.rem_cols = rem_cols
        self.shape = tuple(shape)

    @property
    def R(self):
        return self.data.shape[2]

    @property
    def C(self):
        return self.data.shape[3]

    @property
    def nnz_stored(self):
        return int(np.prod(self.data.shape)) + int(self.rem_data.shape[0])

    def matvec(self, x):
        y = bell_matvec(self.data, self.cols, x, self.shape[0])
        if self.rem_data.shape[0]:
            y = y.index_add_(0, self.rem_rows, self.rem_data * x[self.rem_cols])
        return y

    def __matmul__(self, x):
        return self.matvec(x)

    def diagonal(self):
        return self.diag

    def to_scipy(self):
        import scipy.sparse as sp

        nblk, mt, R, C = self.data.shape
        data = self.data.cpu().numpy()
        cols = self.cols.cpu().numpy()
        b, t, r, c = np.nonzero(data)
        rows = b * R + r
        ccols = cols[b, t].astype(np.int64) * C + c
        vals = data[b, t, r, c]
        n_rows, n_cols = self.shape
        ok = (rows < n_rows) & (ccols < n_cols)
        A = sp.coo_matrix((vals[ok], (rows[ok], ccols[ok])), shape=self.shape)
        if self.rem_data.shape[0]:
            A = A + sp.coo_matrix(
                (self.rem_data.cpu().numpy(),
                 (self.rem_rows.cpu().numpy(), self.rem_cols.cpu().numpy())),
                shape=self.shape)
        return A.tocsr()


def bell_arrays_from_scipy(A, R=8, C=128, mt_cap=None, mt_quantile=99.0, dtype=np.float32, _bchunk=None):
    """The host arrays (data, cols, diag, rem_data, rem_rows, rem_cols,
    shape) of the BELL form of a scipy sparse matrix: the JAX package's
    conversion, copied.

    mt (tiles per row block) is min(max needed, `mt_cap` or the
    `mt_quantile` percentile of per-block tile counts) — dense outlier rows
    (MPC masters) overflow into the COO remainder instead of inflating
    every block."""
    import scipy.sparse as sp

    A = sp.coo_matrix(A)
    n_rows, n_cols = A.shape
    # nblk rounded to a multiple of 16 as in the JAX package (its Pallas
    # grid groups 16 row blocks; trailing blocks are all-zero rows)
    nblk = -(-(-(-n_rows // R)) // 16) * 16
    ntc = -(-n_cols // C)
    row = A.row.astype(np.int64)
    col = A.col.astype(np.int64)
    val = A.data.astype(dtype)
    blk = row // R
    tile = col // C
    key = blk * ntc + tile
    uniq, inv = np.unique(key, return_inverse=True)
    ub = (uniq // ntc).astype(np.int64)
    ut = (uniq % ntc).astype(np.int32)
    counts = np.bincount(ub, minlength=nblk)
    mt_need = int(counts.max()) if counts.size else 1
    mt = mt_need
    if mt_cap is not None:
        mt = min(mt, int(mt_cap))
    elif (counts > 0).any():  # all-zero matrix: skip (percentile on empty raises)
        mt = min(mt, max(int(np.percentile(counts[counts > 0], mt_quantile)), 1))
    mt = max(mt, 1)
    # rank of each unique tile within its block (uniq is (blk, tile)-sorted)
    first = np.searchsorted(ub, np.arange(nblk))
    slot_u = np.arange(len(uniq)) - first[ub]
    keep_u = slot_u < mt

    cols = np.zeros((nblk, mt), dtype=np.int32)
    cols[ub[keep_u], slot_u[keep_u]] = ut[keep_u]

    keep_e = keep_u[inv]
    slot_e = slot_u[inv]
    # scatter-add via bincount on linear indices, chunked over block ranges
    # so the float64 bincount target stays ~1 GB
    lin = (((blk[keep_e] * mt + slot_e[keep_e]) * R + row[keep_e] % R) * C
           + col[keep_e] % C)
    data = np.empty(nblk * mt * R * C, dtype=dtype)
    bchunk = _bchunk or max(1, int(1e9 / (mt * R * C * 8)))
    stride = mt * R * C
    order_l = np.argsort(blk[keep_e], kind="stable")
    lin_s = lin[order_l]
    val_s = val[keep_e][order_l]
    blk_s = blk[keep_e][order_l]
    for b0 in range(0, nblk, bchunk):
        b1 = min(b0 + bchunk, nblk)
        e0, e1 = np.searchsorted(blk_s, [b0, b1])
        seg = np.bincount(lin_s[e0:e1] - b0 * stride,
                          weights=val_s[e0:e1],
                          minlength=(b1 - b0) * stride)
        data[b0 * stride: b1 * stride] = seg
    data = data.reshape(nblk, mt, R, C)

    ov = ~keep_e
    order = np.argsort(row[ov], kind="stable")
    rem_rows = row[ov][order].astype(np.int32)
    rem_cols = col[ov][order].astype(np.int32)
    rem_data = val[ov][order]

    diag = np.asarray(sp.csr_matrix(A).diagonal(), dtype=dtype)
    return data, cols, diag, rem_data, rem_rows, rem_cols, (n_rows, n_cols)


def bell_from_arrays(data, cols, diag, rem_data, rem_rows, rem_cols, shape, device=DEFAULT_DEVICE):
    """BellMatrix on `device` from its host arrays (cols as int32, the
    kernel's type; the remainder's indices as int64)."""
    dev = resolve_device(device)
    f = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return BellMatrix(f(data), torch.as_tensor(np.asarray(cols, np.int32), device=dev), f(diag), f(rem_data),
                      torch.as_tensor(np.asarray(rem_rows, np.int64), device=dev),
                      torch.as_tensor(np.asarray(rem_cols, np.int64), device=dev), shape)


def bell_from_scipy(A, R=8, C=128, mt_cap=None, mt_quantile=99.0, dtype=np.float32, _bchunk=None,
                    device=DEFAULT_DEVICE) -> BellMatrix:
    """Convert a scipy sparse matrix to BELL on `device` (see
    bell_arrays_from_scipy)."""
    dev = resolve_device(device)
    return bell_from_arrays(*bell_arrays_from_scipy(A, R, C, mt_cap, mt_quantile, dtype, _bchunk), device=dev)
