"""The BELL plan of la/bell.py: a conversion of a canonical CSR whose
pattern the port has already converted sends only the values and scatters
them into the tiles on the device.  A hit must return the arrays of a
fresh conversion bit for bit (and so the JAX package's), whatever the
values do; anything that is not exactly the planned pattern, with the same
parameters, must convert afresh.  Small matrices on the CPU."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dolfinx_mpc_tpu.la import bell as jbell
from dolfinx_mpc_tpu_torch.la import bell as pbell
from dolfinx_mpc_tpu_torch.utils import timing as tt

ARRAYS = ("data", "cols", "diag", "rem_data", "rem_rows", "rem_cols")


@pytest.fixture(autouse=True)
def no_plans():
    pbell._plans.clear()
    tt.reset_timings()
    yield
    pbell._plans.clear()
    tt.reset_timings()


def _pattern(n, seed, full_diag):
    """A banded matrix with two dense rows (they overflow into the
    remainder), explicit zeros, and either a diagonal entry in every row or
    rows without one."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 7)
    cols = np.clip(rows + rng.integers(-30, 31, rows.shape[0]), 0, n - 1)
    dense = np.repeat(rng.choice(n, 2, replace=False), n // 2)
    rows = np.concatenate([rows, dense])
    cols = np.concatenate([cols, rng.integers(0, n, dense.shape[0])])
    if full_diag:
        rows, cols = np.concatenate([rows, np.arange(n)]), np.concatenate([cols, np.arange(n)])
    else:
        keep = rows != cols
        rows, cols = rows[keep], cols[keep]
    A = sp.coo_matrix((rng.standard_normal(rows.shape[0]), (rows, cols)), shape=(n, n)).tocsr()
    A.data[::9] = 0.0
    return A


def _values(A, dtype, seed):
    """A with other values in its dtype: some entries become 0 or -0.0,
    some zeros become nonzero, the rest are scaled."""
    rng = np.random.default_rng(seed)
    B = A.astype(dtype)
    v = B.data * (0.9 + 0.2 * rng.random(B.data.shape[0]))
    if np.iscomplexobj(v):
        v = v * np.exp(0.4j)
    v[::5] = 0.0
    v[1::11] = -0.0
    v[::9] = 2.5
    B.data = v.astype(dtype)
    return B


def _counts():
    return {k: v[0] for k, v in tt.trace_timings().items() if k.startswith("bell.plan")}


def _assert_same(B1, B2):
    for name in ARRAYS:
        a, b = getattr(B1, name), getattr(B2, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
        assert a.numpy().tobytes() == b.numpy().tobytes(), name  # bit for bit: -0.0 is not 0.0
    assert B1.shape == B2.shape
    P1, P2 = B1.pack(), B2.pack()
    for name in ("row_ptr", "cols", "vals"):
        assert torch.equal(getattr(P1, name), getattr(P2, name)), name
    assert P1.threads_per_row == P2.threads_per_row


def _assert_jax_equal(A, B, **kw):
    """The port's arrays against the JAX package's conversion; a complex
    matrix part by part (the JAX conversion takes real values only)."""
    parts = ((A, lambda t: t),) if not np.iscomplexobj(A.data) else (
        (A.real.tocsr(), lambda t: t.real), (A.imag.tocsr(), lambda t: t.imag))
    for M, part in parts:
        Bj = jbell.bell_from_scipy(M, dtype=np.empty(0, kw["dtype"]).real.dtype, mt_cap=kw.get("mt_cap"))
        for name in ARRAYS:
            a, b = np.asarray(getattr(Bj, name)), getattr(B, name)
            b = (part(b) if b.is_complex() else b).numpy()
            assert a.shape == b.shape and np.array_equal(a, b.astype(a.dtype)), name


@pytest.mark.parametrize("full_diag", [True, False], ids=["diag", "gaps"])
@pytest.mark.parametrize("kw", [dict(dtype=np.float32), dict(dtype=np.float64), dict(dtype=np.complex64),
                                dict(dtype=np.float64, mt_cap=2)], ids=["f32", "f64", "c64", "f64-mtcap2"])
def test_hit_equals_a_fresh_conversion_and_jax(kw, full_diag):
    """The first conversion is a miss, the second (other values on the same
    pattern) a hit that sends only the values; its arrays and its packed
    layout equal those of a conversion with no plan, bit for bit, and the
    JAX package's arrays."""
    A = _pattern(1100, 1, full_diag)
    pbell.bell_from_scipy(A.astype(kw["dtype"]), device="cpu", **kw)
    A2 = _values(A, kw["dtype"], 2)
    tt.reset_timings()
    hit = pbell.bell_from_scipy(A2, device="cpu", **kw)
    t = tt.trace_timings()
    assert _counts() == {"bell.plan_hit": 1}
    assert t["bell.upload_bytes"][1] == A2.data.nbytes
    assert hit.rem_data.shape[0] > 0
    pbell._plans.clear()
    fresh = pbell.bell_from_scipy(A2, device="cpu", **kw)
    assert _counts() == {"bell.plan_hit": 1, "bell.plan_miss": 1}
    _assert_same(hit, fresh)
    _assert_jax_equal(A2, hit, **kw)


def test_a_changed_column_at_equal_nnz_is_a_miss():
    A = _pattern(200, 3, True)
    pbell.bell_from_scipy(A, device="cpu")
    A2 = A.copy()
    r = 17
    j = A2.indptr[r + 1] - 1  # the row's last entry moves one column right
    assert A2.indices[j] + 1 < A2.shape[1] and A2.indices[j] + 1 not in A2.indices[A2.indptr[r]:j]
    A2.indices[j] += 1
    assert A2.has_canonical_format and A2.nnz == A.nnz
    B = pbell.bell_from_scipy(A2, device="cpu")
    assert _counts() == {"bell.plan_miss": 2} and len(pbell._plans) == 2
    _assert_jax_equal(A2, B, dtype=np.float32)


@pytest.mark.parametrize("form", ["coo", "duplicates", "unsorted"])
def test_non_canonical_input_builds_no_plan(form):
    """COO, a CSR with duplicate entries and one with unsorted indices take
    the host conversion, count neither hit nor miss, keep no plan, and give
    the host conversion's arrays (a duplicate's tile value is the sum)."""
    A = _pattern(150, 4, True)
    if form == "coo":
        M = A.tocoo()
    elif form == "duplicates":
        C = A.tocoo()  # the first 40 entries stored twice, side by side
        order = np.argsort(np.concatenate([np.arange(C.nnz), np.arange(40)]), kind="stable")
        rows, cols = np.concatenate([C.row, C.row[:40]])[order], np.concatenate([C.col, C.col[:40]])[order]
        M = sp.csr_matrix((np.concatenate([C.data, C.data[:40] + 1.0])[order], cols,
                           np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=A.shape[0]))])),
                          shape=A.shape)
    else:
        M = A.copy()
        for r in range(M.shape[0]):
            s = slice(M.indptr[r], M.indptr[r + 1])
            M.indices[s], M.data[s] = M.indices[s][::-1].copy(), M.data[s][::-1].copy()
        M.has_sorted_indices = False
    assert not (M.format == "csr" and M.has_canonical_format)
    for _ in range(2):
        B = pbell.bell_from_scipy(M, device="cpu")
    assert _counts() == {} and pbell._plans == []
    ref = pbell.bell_from_arrays(*pbell.bell_arrays_from_scipy(M), device="cpu")
    _assert_same(B, ref)
    _assert_jax_equal(sp.csr_matrix(M), B, dtype=np.float32)


def test_other_parameters_get_their_own_plan():
    """Another dtype, R, C or mt_cap is a miss with a plan of its own; the
    key holds the device too."""
    A = _pattern(150, 5, False)
    variants = [dict(), dict(dtype=np.float64), dict(R=16), dict(C=64), dict(mt_cap=2)]
    for kw in variants:
        pbell.bell_from_scipy(A, device="cpu", **kw)
    assert _counts() == {"bell.plan_miss": 4 + 1} and len(pbell._plans) == pbell.MAX_PLANS
    for kw in variants[1:]:
        B = pbell.bell_from_scipy(A, device="cpu", **kw)
        _assert_same(B, pbell.bell_from_arrays(*pbell.bell_arrays_from_scipy(A, **kw), device="cpu"))
    assert _counts() == {"bell.plan_miss": 5, "bell.plan_hit": 4}
    keys = {pbell._plan_key(A, 8, 128, None, 99.0, np.float32, torch.device(d)) for d in ("cpu", "cuda", "cuda:1")}
    assert len(keys) == 3


def test_a_fifth_pattern_drops_the_least_recently_used():
    pats = [_pattern(120, 10 + i, True) for i in range(5)]
    for A in pats[:4]:
        pbell.bell_from_scipy(A, device="cpu")
    pbell.bell_from_scipy(pats[0], device="cpu")  # now the most recently used
    pbell.bell_from_scipy(pats[4], device="cpu")  # drops pats[1]
    assert _counts() == {"bell.plan_miss": 5, "bell.plan_hit": 1} and len(pbell._plans) == 4
    pbell.bell_from_scipy(pats[0], device="cpu")
    pbell.bell_from_scipy(pats[1], device="cpu")
    assert _counts() == {"bell.plan_miss": 6, "bell.plan_hit": 2}


def test_a_later_hit_leaves_earlier_matrices_alone():
    """Neither the miss's BellMatrix nor a hit's shares a tensor that holds
    values with a later hit, nor is changed by it."""
    A = _pattern(200, 6, True)
    Bs = [pbell.bell_from_scipy(A, device="cpu")]
    Bs[0].pack()
    saved = [{n: getattr(Bs[0], n).clone() for n in ARRAYS}]
    for seed in (7, 8, 9):
        Bs.append(pbell.bell_from_scipy(_values(A, np.float32, seed), device="cpu"))
        Bs[-1].pack()
        saved.append({n: getattr(Bs[-1], n).clone() for n in ARRAYS})
    assert _counts() == {"bell.plan_miss": 1, "bell.plan_hit": 3}
    for B, arrays in zip(Bs, saved):
        assert all(torch.equal(getattr(B, n), arrays[n]) for n in ARRAYS)
    for i, B in enumerate(Bs):
        for C in Bs[i + 1:]:
            for n in ("data", "diag", "rem_data"):
                a, b = getattr(B, n), getattr(C, n)
                assert a.numel() == 0 or a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
