"""Parity of the port's sparse formats with the JAX package: the slot-CSR
pattern and CSRMatrix (la/sparse.py), node-block ELL (la/ell.py) and
blocked ELL (la/bell.py, whose SpMV is K8 on the card), and the interop
helpers that carry their arrays across.

The conversions are the JAX package's numpy code, copied, so their arrays
must be equal bit for bit on the same scipy input.  The matvecs sum in
another order than XLA: float64 agrees to 1e-12 relative, float32 to
5e-6 (the repo's kernel tolerance, tests/test_pallas_lattice.py:50,84).
K8's plain version is held against the JAX package's Pallas kernel in
interpret mode (f32, the only type that kernel takes) and against its XLA
path.  Inputs come from numpy with fixed seeds (the generators of
tests/test_bell.py and tests/test_ell.py).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from dolfinx_mpc_tpu.la import bell as jbell
from dolfinx_mpc_tpu.la.ell import ell_from_scipy as jx_ell
from dolfinx_mpc_tpu.la.sparse import CSRMatrix as JCSR, build_slot_pattern as jx_pattern
from dolfinx_mpc_tpu_torch.la import bell as pbell
from dolfinx_mpc_tpu_torch.la.ell import ell_from_scipy as pt_ell
from dolfinx_mpc_tpu_torch.la.sparse import CSRMatrix as PCSR, build_slot_pattern as pt_pattern, csr_from_scipy
from dolfinx_mpc_tpu_torch.utils.interop import bell_from_numpy, csr_from_numpy, ell_from_numpy

_ARRAYS = ("data", "cols", "diag", "rem_data", "rem_rows", "rem_cols")


def _rand_mesh_like(n, nnz_per_row, seed, n_dense_rows=0, spread=40):
    """Banded random matrix with mesh-like locality + a few dense rows
    (tests/test_bell.py)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), nnz_per_row)
    cols = np.clip(rows + rng.integers(-spread, spread + 1, rows.shape[0]), 0, n - 1)
    vals = rng.standard_normal(rows.shape[0])
    if n_dense_rows:
        dr = rng.choice(n, n_dense_rows, replace=False)
        drr = np.repeat(dr, n // 3)
        drc = rng.integers(0, n, drr.shape[0])
        rows = np.concatenate([rows, drr])
        cols = np.concatenate([cols, drc])
        vals = np.concatenate([vals, rng.standard_normal(drr.shape[0])])
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def _rand_block_matrix(nn, deg, bs, seed, n_dense_nodes=0):
    """Node-block matrix with a few dense node rows (tests/test_ell.py)."""
    rng = np.random.default_rng(seed)
    rn = np.repeat(np.arange(nn), deg)
    cn = np.clip(rn + rng.integers(-6, 7, rn.shape[0]), 0, nn - 1)
    if n_dense_nodes:
        dn = rng.choice(nn, n_dense_nodes, replace=False)
        drn = np.repeat(dn, nn // 2)
        dcn = rng.integers(0, nn, drn.shape[0])
        rn = np.concatenate([rn, drn])
        cn = np.concatenate([cn, dcn])
    rows = (rn[:, None, None] * bs + np.arange(bs)[None, :, None]).ravel()
    cols = (cn[:, None, None] * bs + np.arange(bs)[None, None, :]).ravel()
    vals = rng.standard_normal(rows.shape[0])
    return sp.coo_matrix((vals, (rows, cols)), shape=(nn * bs, nn * bs)).tocsr()


def _rel_l2(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _assert_arrays_equal(jm, pm):
    """Every array of a JAX ELL/BELL matrix equals the port's, exactly."""
    for name in _ARRAYS:
        a, b = np.asarray(getattr(jm, name)), getattr(pm, name).numpy()
        assert a.shape == b.shape, name
        assert np.array_equal(a, b.astype(a.dtype)), name
    assert tuple(jm.shape) == pm.shape


# ---------------------------------------------------------------------------
# slot CSR
# ---------------------------------------------------------------------------


def _batches(seed):
    rng = np.random.default_rng(seed)
    n = 37
    b1 = (rng.integers(0, n, (9, 4, 4)), rng.integers(0, n, (9, 4, 4)))
    r2, c2 = rng.integers(-1, n, (5, 6, 6)), rng.integers(0, n, (5, 6, 6))
    diag = np.arange(n)
    return n, [b1, (r2, c2), (diag, diag)], [None, r2 >= 0, None]


def test_build_slot_pattern_matches_jax():
    n, batches, masks = _batches(0)
    pj = jx_pattern((n, n), batches, masks)
    pp = pt_pattern((n, n), batches, masks)
    for name in ("indptr", "indices", "row_ids"):
        assert np.array_equal(getattr(pj, name), getattr(pp, name)), name
    assert pj.nnz == pp.nnz and len(pj.slots) == len(pp.slots) == 3
    for sj, sq in zip(pj.slots, pp.slots):
        assert np.array_equal(sj, sq)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 5e-6)])
def test_csr_matvec_diagonal_to_scipy_match_jax(dtype, tol):
    n, batches, masks = _batches(1)
    pat = jx_pattern((n, n), batches, masks)
    data = np.random.default_rng(2).standard_normal(pat.nnz).astype(dtype)
    Aj = JCSR.from_pattern(pat, jnp.asarray(data))
    x = np.random.default_rng(3).standard_normal(n).astype(dtype)
    y_ref = np.asarray(Aj.matvec(jnp.asarray(x)))
    for Ap in (PCSR.from_pattern(pt_pattern((n, n), batches, masks), torch.as_tensor(data)),
               csr_from_numpy(np.asarray(Aj.data), np.asarray(Aj.indices), np.asarray(Aj.indptr), Aj.shape,
                              device="cpu"),
               csr_from_scipy(Aj.to_scipy(), device="cpu")):
        assert _rel_l2(Ap.matvec(torch.as_tensor(x)).numpy(), y_ref) < tol
        assert np.array_equal(Ap.diagonal().numpy(), np.asarray(Aj.diagonal()))
        assert abs(Ap.to_scipy() - Aj.to_scipy()).max() == 0
        assert np.array_equal(Ap.to_dense(), Aj.to_dense())


# ---------------------------------------------------------------------------
# node-block ELL
# ---------------------------------------------------------------------------


def _ell_cases():
    rng = np.random.default_rng(7)
    nf, nc, bs = 120, 17, 3
    rn = np.repeat(np.arange(nf), 4)
    cn = rng.integers(0, nc, rn.shape[0])
    rows = (rn[:, None, None] * bs + np.arange(bs)[None, :, None]).ravel()
    cols = (cn[:, None, None] * bs + np.arange(bs)[None, None, :]).ravel()
    P = sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)), shape=(nf * bs, nc * bs)).tocsr()
    spill = _rand_block_matrix(180, 7, 3, seed=3, n_dense_nodes=3)
    nondiv = sp.random(101, 101, density=0.05, random_state=4, format="csr") + sp.eye(101)
    return {
        "scalar": (_rand_block_matrix(211, 9, 1, seed=211), dict(br=1, dtype=np.float64)),
        "bs3_dense": (_rand_block_matrix(150, 12, 3, seed=150, n_dense_nodes=2), dict(br=3, dtype=np.float64)),
        "bs2_dense": (_rand_block_matrix(64, 5, 2, seed=64, n_dense_nodes=1), dict(br=2, dtype=np.float64)),
        "rect_P": (P, dict(br=3, dtype=np.float64)),
        "rect_R": (sp.csr_matrix(P.T), dict(br=3, dtype=np.float64)),
        "spill_kcap": (spill, dict(br=3, k_cap=8, dtype=np.float64)),
        "spill_quantile": (spill, dict(br=3, k_quantile=95.0, dtype=np.float64)),
        "nondivisible_f32": (nondiv, dict(br=3, dtype=np.float32)),
    }


@pytest.mark.parametrize("case", list(_ell_cases()))
def test_ell_from_scipy_equals_jax(case):
    A, kw = _ell_cases()[case]
    Ej = jx_ell(A, **kw)
    Ep = pt_ell(A, device="cpu", **kw)
    _assert_arrays_equal(Ej, Ep)
    dt = kw["dtype"]
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(dt)
    y_ref = np.asarray(Ej.matvec(jnp.asarray(x)))
    tol = 1e-12 if dt == np.float64 else 5e-6
    assert _rel_l2(Ep.matvec(torch.as_tensor(x)).numpy(), y_ref) < tol
    assert abs(Ep.to_scipy() - Ej.to_scipy()).max() == 0
    assert np.array_equal(Ep.diagonal().numpy(), np.asarray(Ej.diagonal()))


# ---------------------------------------------------------------------------
# blocked ELL (K8's format)
# ---------------------------------------------------------------------------


def _bell_cases():
    chunk = sp.random(700, 700, density=0.01, random_state=3, format="csr") + sp.eye(700)
    return {
        "317_f32": (_rand_mesh_like(317, 9, seed=317), dict(dtype=np.float32)),
        "1024_dense3_f32": (_rand_mesh_like(1024, 15, seed=1024, n_dense_rows=3), dict(dtype=np.float32)),
        "73_dense1_f32": (_rand_mesh_like(73, 5, seed=73, n_dense_rows=1), dict(dtype=np.float32)),
        "317_f64": (_rand_mesh_like(317, 9, seed=317), dict(dtype=np.float64)),
        "1024_dense3_f64": (_rand_mesh_like(1024, 15, seed=1024, n_dense_rows=3), dict(dtype=np.float64)),
        "73_dense1_f64": (_rand_mesh_like(73, 5, seed=73, n_dense_rows=1), dict(dtype=np.float64)),
        "overflow_mtcap2": (_rand_mesh_like(400, 7, seed=3, n_dense_rows=4), dict(mt_cap=2, dtype=np.float64)),
        "chunked_bchunk3": (chunk, dict(_bchunk=3)),
    }


@pytest.mark.parametrize("case", list(_bell_cases()))
def test_bell_from_scipy_equals_jax(case):
    A, kw = _bell_cases()[case]
    Bj = jbell.bell_from_scipy(A, **kw)
    Bp = pbell.bell_from_scipy(A, device="cpu", **kw)
    _assert_arrays_equal(Bj, Bp)
    if "mt_cap" in kw:
        assert Bp.rem_data.shape[0] > 0
    if "_bchunk" in kw:  # the chunked conversion equals the single-shot one
        B1 = pbell.bell_from_scipy(A, device="cpu")
        assert torch.equal(B1.data, Bp.data) and torch.equal(B1.cols, Bp.cols)
    dt = kw.get("dtype", np.float32)
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(dt)
    y_ref = np.asarray(Bj.matvec(jnp.asarray(x)))
    tol = 1e-12 if dt == np.float64 else 5e-6
    n0 = pbell.bell_matvec.launches
    assert _rel_l2(Bp.matvec(torch.as_tensor(x)).numpy(), y_ref) < tol
    assert pbell.bell_matvec.launches == n0  # CPU tensors launch nothing
    assert abs(Bp.to_scipy() - Bj.to_scipy()).max() == 0
    assert np.array_equal(Bp.diagonal().numpy(), np.asarray(Bj.diagonal()))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 5e-6), (np.float64, 1e-12)])
def test_bell_matvec_plain_matches_pallas_interpret_and_xla(dtype, tol):
    """K8's plain version against the JAX package's Pallas kernel in
    interpret mode (float32: the TPU kernel accumulates in float32) and its
    XLA path, on the block rows (nblk * R values, trailing zero rows too)."""
    A = _rand_mesh_like(700, 11, seed=9, n_dense_rows=2)
    Bj = jbell.bell_from_scipy(A, dtype=dtype)
    x = np.random.default_rng(3).standard_normal(700).astype(dtype)
    x2 = Bj._x_tiles(jnp.asarray(x))
    nblk, mt, R, C = Bj.data.shape
    xla = np.asarray(jnp.sum(Bj.data * x2[Bj.cols][:, :, None, :], axis=(1, 3))).reshape(-1)
    got = pbell.bell_matvec_plain(torch.as_tensor(np.asarray(Bj.data)), torch.as_tensor(np.asarray(Bj.cols)),
                                  torch.as_tensor(x)).numpy()
    assert got.shape == (nblk * R,)
    assert _rel_l2(got, xla) < tol
    if dtype == np.float32:
        pallas = np.asarray(jbell._bell_matvec_pallas(nblk, mt, R, C, x2.shape[0], interpret=True)(
            Bj.cols, Bj.data, x2)).reshape(-1)
        assert _rel_l2(got, pallas) < tol
    # and the first n_rows rows of it, as BellMatrix.matvec takes them
    sub = pbell.bell_matvec(torch.as_tensor(np.asarray(Bj.data)), torch.as_tensor(np.asarray(Bj.cols)),
                            torch.as_tensor(x), 700).numpy()
    assert np.array_equal(sub, got[:700])


def test_bell_wrapper_refuses_other_devices():
    """A tensor on a non-CPU, non-CUDA device raises instead of falling
    back to the plain version."""
    Bp = pbell.bell_from_scipy(_rand_mesh_like(73, 5, seed=73), device="cpu")
    x = torch.ones(73, dtype=torch.float32)
    with pytest.raises(RuntimeError):
        pbell.bell_matvec(Bp.data.to("meta"), Bp.cols.to("meta"), x.to("meta"), 73)


def test_interop_round_trips():
    """csr/ell/bell_from_numpy build the port's matrices from the JAX
    package's arrays: same arrays, same operator."""
    A = _rand_block_matrix(150, 12, 3, seed=150, n_dense_nodes=2)
    Ej = jx_ell(A, br=3, k_cap=10, dtype=np.float64)
    Ep = ell_from_numpy(*(np.asarray(getattr(Ej, n)) for n in _ARRAYS), Ej.shape, device="cpu")
    _assert_arrays_equal(Ej, Ep)
    assert abs(Ep.to_scipy() - A).max() < 1e-14
    Bj = jbell.bell_from_scipy(A, mt_cap=3, dtype=np.float64)
    Bp = bell_from_numpy(*(np.asarray(getattr(Bj, n)) for n in _ARRAYS), Bj.shape, device="cpu")
    _assert_arrays_equal(Bj, Bp)
    assert Bp.cols.dtype == torch.int32 and Bp.rem_data.shape[0] > 0
    assert abs(Bp.to_scipy() - A).max() < 1e-14
    Cp = csr_from_numpy(A.data, A.indices, A.indptr, A.shape, device="cpu")
    assert abs(Cp.to_scipy() - A).max() == 0
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(A.shape[0]))
    for M in (Ep, Bp, Cp):
        assert _rel_l2(M.matvec(x).numpy(), A @ x.numpy()) < 1e-12
