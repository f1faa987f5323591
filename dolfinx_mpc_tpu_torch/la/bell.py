"""Blocked-ELL (BELL) sparse matrix and its SpMV kernel K8 (torch + CUDA).

Counterpart of ``dolfinx_mpc_tpu/la/bell.py``.  Rows are grouped into
blocks of R=8, columns into aligned tiles of C=128, and every (row block,
column tile) pair holding a nonzero stores a dense (R, C) tile:

    y[b*R + r] = sum_t  data[b, t, r, :] . x[cols[b, t]*C : +C]

Rows denser than the ``mt`` tile budget (MPC slave rows coupling to
far-away masters) spill their overflow nonzeros to a COO remainder.

The tiles are the TPU's format.  On the card the operator is also held as
``BellPacked``, a CSR of its nonzeros alone (``bell_pack``: the tile
nonzeros of each row in (t, lane) order, then the row's remainder entries),
built once per operator when the BellMatrix is made on a CUDA device.

- **K8** ``bell_matvec`` replaces the TPU kernel ``_bell_matvec_pallas``
  (``dolfinx_mpc_tpu/la/bell.py:147-189``) and the JAX ``segment_sum`` of
  the remainder (``:113-116``): one launch over the packed layout, the
  remainder included.  Its CUDA source is ``csrc/bell_kernels.cu``; every
  ``BellMatrix.matvec`` on a CUDA tensor launches it, in float32, float64,
  complex64 and complex128, or raises.
- ``bell_packed_matvec_plain`` is K8's plain version (gather, multiply,
  row ``index_add_`` over the packed layout); the wrapper runs it for CPU
  tensors.
- ``bell_matvec_plain`` is the JAX package's XLA tile path (gather of x
  tiles, multiply, sum over (t, C)); ``BellMatrix.matvec`` on the CPU runs
  it plus the remainder, as the JAX package does.

The conversion ``bell_from_scipy`` is the JAX package's numpy code, copied.
It keeps a plan of each canonical CSR pattern it converts (``_BellPlan``),
so that a later conversion of the same pattern with other values (a
reassembled operator) sends only the values and scatters them into the
tiles on the device, with the same arrays as a fresh conversion.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from .._launch import count_launch, launch_check, on_device
from ..utils.timing import count, span, traced

__all__ = ["BellMatrix", "BellPacked", "bell_from_scipy", "bell_matvec", "bell_matvec_plain", "bell_pack",
           "bell_packed_matvec_plain"]

# K8's dtypes, by the suffix of their launchers
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.complex64: "c64", torch.complex128: "c128"}


def declare_signatures(lib: ctypes.CDLL) -> None:
    """ctypes argtypes/restype of the launchers in csrc/bell_kernels.cu."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for suf in _SUFFIX.values():
        fn = getattr(lib, f"dmt_bell_csr_matvec_{suf}")
        fn.argtypes = [P, P, P, P, P, I, I, P]
        fn.restype = I


def bell_matvec_plain(data, cols, x, n_rows=None):
    """Plain PyTorch BELL tile product (the JAX package's XLA path, la/bell.py:
    110-111): x zero-padded to whole tiles, the tiles of each block gathered
    by cols, multiplied and summed over (t, C).  data (nblk, mt, R, C), cols
    (nblk, mt), x (n_cols,); returns the first n_rows (default nblk*R) rows.
    The COO remainder is not in it."""
    nblk, mt, R, C = data.shape
    n = x.shape[0]
    ntc = -(-n // C)
    x2 = torch.nn.functional.pad(x, (0, ntc * C - n)).reshape(ntc, C)
    xg = x2[cols.long()]  # (nblk, mt, C)
    y = (data * xg[:, :, None, :]).sum(dim=(1, 3)).reshape(-1)
    return y if n_rows is None else y[:n_rows]


def _threads_per_row(nnz, n_rows):
    """K8's sub-warp width: the power of two in [2, 32] nearest above a
    sixth of the mean row length (8 at the contact operator's 42.7)."""
    mean = nnz / max(n_rows, 1)
    g = 2
    while g < 32 and g < mean / 6:
        g *= 2
    return g


class BellPacked:
    """The nonzeros of a BELL operator as a CSR, K8's layout: row_ptr
    (n_rows + 1,) int32, cols (nnz,) int32 absolute columns, vals (nnz,) in
    the operator's dtype; each row holds its tile nonzeros in (t, lane)
    order, then its remainder entries.  ``threads_per_row`` is the sub-warp
    width K8 launches with."""

    def __init__(self, row_ptr, cols, vals, shape):
        self.row_ptr = row_ptr
        self.cols = cols
        self.vals = vals
        self.shape = tuple(shape)
        self.threads_per_row = _threads_per_row(int(vals.shape[0]), self.shape[0])
        self._launch = None

    @property
    def device(self):
        return self.vals.device

    @property
    def nnz(self):
        return int(self.vals.shape[0])

    @property
    def nbytes(self):
        return sum(t.numel() * t.element_size() for t in (self.row_ptr, self.cols, self.vals))

    def to_scipy(self):
        import scipy.sparse as sp

        return sp.csr_matrix((self.vals.cpu().numpy(), self.cols.cpu().numpy(), self.row_ptr.cpu().numpy()),
                             shape=self.shape)


def bell_pack(data, cols, rem_data, rem_rows, rem_cols, shape) -> BellPacked:
    """The packed layout of the BELL arrays, on their device: every nonzero
    of the tiles (dropped where it falls outside `shape`, as to_scipy drops
    it) with its absolute column cols[b, t]*C + lane, then the remainder,
    sorted stably by row, so that a row keeps the (t, lane) order of its
    tile entries followed by its remainder entries.  Explicit zeros, in the
    tiles or the remainder, drop out (nothing in A x changes)."""
    nblk, mt, R, C = data.shape
    n_rows, n_cols = (int(v) for v in shape)
    b, t, r, c = torch.nonzero(data, as_tuple=True)
    rows = b * R + r
    ccols = cols[b, t].long() * C + c
    vals = data[b, t, r, c]
    ok = (rows < n_rows) & (ccols < n_cols)
    rem_data = rem_data.to(vals.device, vals.dtype)
    rem_ok = rem_data != 0
    rows = torch.cat([rows[ok], rem_rows.to(rows.device).long()[rem_ok]])
    ccols = torch.cat([ccols[ok], rem_cols.to(rows.device).long()[rem_ok]])
    vals = torch.cat([vals[ok], rem_data[rem_ok]])
    if vals.shape[0] >= 2 ** 31 or n_cols >= 2 ** 31:
        raise ValueError(f"bell_pack: {vals.shape[0]} nonzeros / {n_cols} columns exceed int32 indices")
    order = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=n_rows)
    row_ptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return BellPacked(row_ptr.to(torch.int32), ccols[order].to(torch.int32), vals[order].contiguous(),
                      (n_rows, n_cols))


def bell_packed_matvec_plain(packed: BellPacked, x):
    """Plain PyTorch version of K8 on the packed layout: the products
    vals * x[cols] added into their rows in storage order (index_add_), any
    device."""
    n_rows = packed.shape[0]
    lengths = (packed.row_ptr[1:] - packed.row_ptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(n_rows, device=x.device), lengths)
    y = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    return y.index_add_(0, rows, packed.vals * x[packed.cols.long()])


class _K8Launch:
    """K8 prepared once per packed operator on the card: the ctypes
    function, the layout's pointers, the row count and the sub-warp width."""

    def __init__(self, packed: BellPacked):
        if packed.device.type != "cuda":
            raise RuntimeError(f"bell_matvec: the packed layout lies on {packed.device}")
        if packed.vals.dtype not in _SUFFIX:
            raise TypeError(f"bell_matvec: dtype {packed.vals.dtype} is not float32/float64/complex64/complex128")
        n_rows, n_cols = packed.shape
        if n_rows * packed.threads_per_row >= 2 ** 31:
            raise ValueError(f"bell_matvec: {n_rows} rows x {packed.threads_per_row} threads exceed int32")
        from .._build import load_kernels

        self.device, self.dtype, self.n_rows, self.n_cols = packed.device, packed.vals.dtype, n_rows, n_cols
        self.index = packed.device.index if packed.device.index is not None else torch.cuda.current_device()
        self.fn = getattr(load_kernels(), f"dmt_bell_csr_matvec_{_SUFFIX[self.dtype]}")
        self.args = (packed.row_ptr.data_ptr(), packed.cols.data_ptr(), packed.vals.data_ptr())
        self.g = packed.threads_per_row

    def __call__(self, x):
        if x.device != self.device:
            raise RuntimeError(f"bell_matvec: operator on {self.device}, x on {x.device}")
        if x.dtype != self.dtype:
            raise TypeError(f"bell_matvec: operator {self.dtype}, x {x.dtype}")
        if x.dim() != 1 or x.shape[0] != self.n_cols or not x.is_contiguous():
            raise ValueError(f"bell_matvec: x {tuple(x.shape)}, need a contiguous ({self.n_cols},) vector")
        y = torch.empty(self.n_rows, dtype=self.dtype, device=self.device)
        rp, cp, vp = self.args
        xp, yp = x.data_ptr(), y.data_ptr()
        launch_check(on_device(self.index, lambda st: self.fn(rp, cp, vp, xp, yp, self.n_rows, self.g, st)),
                     "bell_matvec")
        return y


def bell_matvec(B, x):
    """K8: y = A x for the operator of BellMatrix B (or of the BellPacked
    B itself), on B's packed layout
    (the tile product plus the COO remainder, rows 0 .. n_rows-1); x
    (n_cols,) of B's dtype: float32, float64, complex64 or complex128.

    Replaces the TPU kernel dolfinx_mpc_tpu/la/bell.py:_bell_matvec_pallas
    and the remainder's segment_sum: one launch on PyTorch's current stream,
    a sub-warp of threads per row over the row's nonzeros
    (csrc/bell_kernels.cu).  Bound by device memory: the nonzeros (value +
    int32 column), the row pointers, x and y, each once.  The launch is
    prepared once per operator.  CPU tensors run the plain version; B must
    hold its packed layout (made on a CUDA device, or by B.pack())."""
    P = B if isinstance(B, BellPacked) else B.packed
    if P is None:
        raise ValueError("bell_matvec: the BellMatrix holds no packed layout (BellMatrix.pack())")
    if P.device.type == "cpu" and x.device.type == "cpu":
        return bell_packed_matvec_plain(P, x)
    if P.device.type != "cuda" or x.device.type != "cuda":
        raise RuntimeError(f"bell_matvec: operator on {P.device}, x on {x.device}")
    if P._launch is None:
        P._launch = _K8Launch(P)
    y = P._launch(x)
    count_launch(bell_matvec, y.dtype)
    return y


bell_matvec.launches = 0
bell_matvec.launches_by_dtype = {}


class BellMatrix:
    """data: (nblk, mt, R, C) dense tiles; cols: (nblk, mt) int32 column
    TILE indices (padded slots point at tile 0 with zero data); diag: (n,)
    stored at conversion; rem_*: COO overflow (rows and columns int64);
    packed: K8's layout (BellPacked), made at construction on a CUDA
    device, else None until pack() is called.  The tiles stay on the
    device too: the plain tile product and to_scipy read them, and they
    are what the JAX package's arrays compare with."""

    def __init__(self, data, cols, diag, rem_data, rem_rows, rem_cols, shape):
        self.data = data
        self.cols = cols
        self.diag = diag
        self.rem_data = rem_data
        self.rem_rows = rem_rows
        self.rem_cols = rem_cols
        self.shape = tuple(shape)
        self.packed = None
        if data.device.type == "cuda":
            self.pack()

    def pack(self) -> BellPacked:
        """Build (again) and keep the packed layout on the tiles' device."""
        self.packed = bell_pack(self.data, self.cols, self.rem_data, self.rem_rows, self.rem_cols, self.shape)
        return self.packed

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
        """K8 on the card (one launch, remainder included); on the CPU the
        JAX package's tile product plus the remainder's scatter-add."""
        if x.device.type == "cpu" and self.data.device.type == "cpu":
            y = bell_matvec_plain(self.data, self.cols, x, self.shape[0])
            if self.rem_data.shape[0]:
                y = y.index_add_(0, self.rem_rows, self.rem_data * x[self.rem_cols])
            return y
        return bell_matvec(self, x)

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


@traced("bell.pack")
def bell_arrays_from_scipy(A, R=8, C=128, mt_cap=None, mt_quantile=99.0, dtype=np.float32, _bchunk=None):
    """The host arrays (data, cols, diag, rem_data, rem_rows, rem_cols,
    shape) of the BELL form of a scipy sparse matrix: the JAX package's
    conversion, copied, except that complex values scatter part by part
    (numpy's bincount takes real weights only, so the JAX package's
    conversion raises TypeError for a complex matrix).

    mt (tiles per row block) is min(max needed, `mt_cap` or the
    `mt_quantile` percentile of per-block tile counts) — dense outlier rows
    (MPC masters) overflow into the COO remainder instead of inflating
    every block."""
    return _bell_arrays(A, R, C, mt_cap, mt_quantile, dtype, _bchunk)


def _bell_arrays(A, R, C, mt_cap, mt_quantile, dtype, _bchunk, keep=None):
    """bell_arrays_from_scipy's work.  Given a dict `keep`, also puts in it
    where each stored entry of A went (A's entries in COO order, which for
    a canonical CSR is its storage order): "lin", the linear tile position
    of each entry kept in the tiles; "kept", which entries those are;
    "rem_src", the entry of each remainder slot; "diag", the rows that
    store a diagonal entry and those entries."""
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
        idx, w, size = lin_s[e0:e1] - b0 * stride, val_s[e0:e1], (b1 - b0) * stride
        if np.iscomplexobj(w):
            # bincount takes real weights: the two parts apart, as ell.py does
            seg = np.bincount(idx, weights=w.real, minlength=size) + 1j * np.bincount(idx, weights=w.imag,
                                                                                       minlength=size)
        else:
            seg = np.bincount(idx, weights=w, minlength=size)
        data[b0 * stride: b1 * stride] = seg
    data = data.reshape(nblk, mt, R, C)

    ov = ~keep_e
    order = np.argsort(row[ov], kind="stable")
    rem_rows = row[ov][order].astype(np.int32)
    rem_cols = col[ov][order].astype(np.int32)
    rem_data = val[ov][order]

    diag = np.asarray(sp.csr_matrix(A).diagonal(), dtype=dtype)
    if keep is not None:
        on_diag = np.flatnonzero(row == col)
        keep.update(lin=lin, kept=keep_e, rem_src=np.flatnonzero(ov)[order], diag=(row[on_diag], on_diag))
    return data, cols, diag, rem_data, rem_rows, rem_cols, (n_rows, n_cols)


@traced("bell.upload")
def bell_from_arrays(data, cols, diag, rem_data, rem_rows, rem_cols, shape, device=DEFAULT_DEVICE):
    """BellMatrix on `device` from its host arrays (cols as int32; the
    remainder's indices as int64).  On a CUDA device the BellMatrix packs
    its nonzeros for K8 there and then.  Counts the bytes of the host
    arrays in ``bell.upload_bytes``."""
    dev = resolve_device(device)
    host = (np.ascontiguousarray(data), np.asarray(cols, np.int32), np.ascontiguousarray(diag),
            np.ascontiguousarray(rem_data), np.asarray(rem_rows, np.int64), np.asarray(rem_cols, np.int64))
    count("bell.upload_bytes", sum(a.nbytes for a in host))
    return BellMatrix(*(torch.as_tensor(a, device=dev) for a in host), shape)


# The most BELL plans kept, the least recently used dropped first: enough
# for a Stokes nest's blocks and a contact operator together.
MAX_PLANS = 4
_plans: list = []  # _BellPlan, the most recently used last
_plans_lock = threading.Lock()


class _BellPlan:
    """Where the values of one sparsity pattern go in its BELL form, kept
    from the conversion that first met the pattern: the pattern itself
    (host copies of indptr and indices, for an exact compare), the tile
    shape, and on the target device the pattern's own arrays (cols and the
    remainder's indices, shared with that first BellMatrix, which never
    writes them) and int32 maps of the stored entries: ``tile_src`` the
    entries kept in the tiles and ``tile_pos`` their linear tile positions,
    ``rem_src`` the entry of each remainder slot, ``diag_src`` the diagonal
    entries of the rows ``diag_rows``."""

    def __init__(self, key, A, keep, B):
        def ix(a):
            small = a.size == 0 or int(a.max()) < 2 ** 31
            return torch.as_tensor(a.astype(np.int32 if small else np.int64), device=B.data.device)

        self.key, self.shape, self.data_shape = key, B.shape, tuple(B.data.shape)
        self.indptr, self.indices = A.indptr.copy(), A.indices.copy()
        self.cols, self.rem_rows, self.rem_cols = B.cols, B.rem_rows, B.rem_cols
        self.tile_src, self.tile_pos = ix(np.flatnonzero(keep["kept"])), ix(keep["lin"])
        self.rem_src = ix(keep["rem_src"])
        self.diag_rows, self.diag_src = (ix(a) for a in keep["diag"])


def _plan_key(A, R, C, mt_cap, mt_quantile, dtype, dev):
    """The key of A's plan, or None where A is not a canonical CSR (sorted
    indices, no duplicates): the tiles of duplicates are sums, which only
    the host conversion makes."""
    import scipy.sparse as sp

    if not (sp.issparse(A) and A.format == "csr" and A.has_canonical_format):
        return None
    return tuple(A.shape), R, C, mt_cap, mt_quantile, np.dtype(dtype), dev


def _find_plan(key, A):
    """The plan of A's pattern under `key`, made the most recently used; or
    None.  The pattern is compared in full every time."""
    with _plans_lock:
        for i, plan in enumerate(_plans):
            if plan.key == key and np.array_equal(plan.indptr, A.indptr) and np.array_equal(plan.indices, A.indices):
                _plans.append(_plans.pop(i))
                return plan
    return None


@traced("bell.upload")
def _bell_from_plan(plan, vals):
    """The BellMatrix of a planned pattern from its values on the host (in
    the target dtype): only the values are sent; the tiles are zeroed and
    the values scattered into them on the device, and the diagonal and the
    remainder gathered, so every array equals the host conversion's."""
    count("bell.upload_bytes", vals.nbytes)
    v = torch.as_tensor(vals, device=plan.cols.device)
    # + 0 turns a stored -0.0 into 0.0, as the host conversion's sums do
    # in the tiles and the diagonal (its remainder keeps the value as is)
    v0 = v + 0
    data = torch.zeros(plan.data_shape, dtype=v.dtype, device=v.device)
    data.view(-1)[plan.tile_pos] = v0[plan.tile_src]
    diag = torch.zeros(plan.shape[0], dtype=v.dtype, device=v.device)
    diag[plan.diag_rows] = v0[plan.diag_src]
    return BellMatrix(data, plan.cols, diag, v[plan.rem_src], plan.rem_rows, plan.rem_cols, plan.shape)


def bell_from_scipy(A, R=8, C=128, mt_cap=None, mt_quantile=99.0, dtype=np.float32, _bchunk=None,
                    device=DEFAULT_DEVICE) -> BellMatrix:
    """Convert a scipy sparse matrix to BELL on `device` (see
    bell_arrays_from_scipy).

    A canonical CSR keeps a plan of its pattern (``_BellPlan``, at most
    MAX_PLANS of them): a later conversion of a matrix whose indptr and
    indices are equal to a plan's, with the same parameters, dtype and
    device, casts and sends only the values and scatters them on the
    device, and returns the same arrays.  Counts ``bell.plan_hit`` or
    ``bell.plan_miss`` once per conversion of a canonical CSR."""
    dev = resolve_device(device)
    key = _plan_key(A, R, C, mt_cap, mt_quantile, dtype, dev)
    keep = None if key is None else {}
    with span("bell.pack"):
        plan = None if key is None else _find_plan(key, A)
        if plan is not None:
            vals = A.data.astype(dtype)
        else:
            arrays = _bell_arrays(A, R, C, mt_cap, mt_quantile, dtype, _bchunk, keep)
    if plan is not None:
        count("bell.plan_hit", 1)
        return _bell_from_plan(plan, vals)
    B = bell_from_arrays(*arrays, device=dev)
    if key is not None:
        count("bell.plan_miss", 1)
        plan = _BellPlan(key, A, keep, B)
        with _plans_lock:
            _plans.append(plan)
            del _plans[:-MAX_PLANS]
    return B
