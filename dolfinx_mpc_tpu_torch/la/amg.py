"""Algebraic multigrid (smoothed aggregation) for unstructured operators
(torch).

Counterpart of ``dolfinx_mpc_tpu/la/amg.py``.  The SET-UP runs on the host in
numpy/scipy and is the JAX package's code, copied verbatim and seeded as
there, so both packages build the same hierarchy bit for bit: strength
graph, MIS-based aggregation, per-aggregate QR of the near-nullspace
candidates (pass ``nullspace=rigid_motions_nullspace(V)`` for elasticity),
smoothed prolongator, Galerkin triple products, Lanczos spectrum bounds and
the dense inverse of the coarsest level.  The V-CYCLE is plain torch on the
levels' device: Chebyshev smoothing on D^-1 A, transfers as sparse
matvecs, and the coarsest level as one dense matmul (TF32 off package-wide).
On a CUDA device the levels of at least ``ell_min`` rows are node-block
ELL (the JAX package's accelerator branch), the others CSR; on the CPU all
are CSR, as the JAX package on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device

__all__ = ["AMG", "smoothed_aggregation_amg"]


# ---------------------------------------------------------------- setup ---

def _safe_inv(d):
    """Elementwise 1/d with zeros kept zero (no divide-by-zero warning)."""
    d = np.asarray(d, np.float64)
    out = np.zeros_like(d)
    np.divide(1.0, d, out=out, where=d != 0)
    return out


def _node_graph(A, bs):
    """Collapse a bs-blocked dof matrix to its node graph (max |entry| per
    block)."""
    import scipy.sparse as sp

    if bs == 1:
        return A
    n = A.shape[0] // bs
    C = A.tocoo()
    r = C.row // bs
    c = C.col // bs
    M = sp.coo_matrix((np.abs(C.data), (r, c)), shape=(n, n))
    M.sum_duplicates()  # sum ~ Frobenius-ish collapse; only relative size matters
    return M.tocsr()


def _strength(A, theta):
    """Symmetric strength-of-connection: keep |a_ij| >= theta*sqrt(a_ii a_jj)."""
    import scipy.sparse as sp

    d = np.sqrt(np.abs(A.diagonal()) + 1e-300)
    C = A.tocoo()
    keep = (C.row != C.col) & (np.abs(C.data) >= theta * d[C.row] * d[C.col])
    S = sp.csr_matrix(
        (np.ones(int(keep.sum()), np.int8), (C.row[keep], C.col[keep])),
        shape=A.shape,
    )
    return S


def _aggregate(S, seed=0):
    """MIS-based aggregation, fully vectorized.

    Roots are a maximal independent set of the strength graph chosen by
    random priority (each round, a node whose priority beats every live
    neighbor's becomes a root and retires its neighborhood); every root
    absorbs its strong neighbors, leftovers join an adjacent aggregate or
    become singletons.  Aggregate ids are relabeled in min-fine-node order
    to preserve dof locality for the BELL tiles downstream."""
    n = S.shape[0]
    indptr, indices = S.indptr, S.indices
    deg = np.diff(indptr)
    rng = np.random.default_rng(seed)
    pri = rng.permutation(n).astype(np.int64)

    INF = np.iinfo(np.int64).max
    nz = np.flatnonzero(deg > 0)  # rows with neighbors (reduceat segments:
    # deg-0 rows between consecutive nz rows contribute no entries, so
    # indptr[nz] segments are exact and strictly increasing)

    def nbr_min(vals):
        """per-node min of vals over strong neighbors (INF where none)."""
        out = np.full(n, INF)
        if nz.size:
            out[nz] = np.minimum.reduceat(vals[indices], indptr[nz])
        return out

    def nbr_any(mask):
        out = np.zeros(n, bool)
        if nz.size:
            out[nz] = np.add.reduceat(
                mask[indices].astype(np.int64), indptr[nz]) > 0
        return out

    # roots = maximal independent set of the DISTANCE-2 strength graph
    # (distance-1 MIS checkerboards a grid into size-2 aggregates): a live
    # node roots when its priority is the min over its closed 2-ring
    state = np.zeros(n, np.int8)  # 0 live, 1 root, 2 retired
    for _ in range(200):
        live = state == 0
        if not live.any():
            break
        p = np.where(live, pri, INF)
        m1 = np.minimum(p, nbr_min(p))  # min over closed 1-ring
        m2 = nbr_min(m1)  # min over (self-inclusive) 2-ring
        roots = live & (pri <= np.minimum(m1, m2))
        if not roots.any():
            break
        state[roots] = 1
        r1 = nbr_any(roots)
        r2 = nbr_any(r1 | roots)
        state[(state == 0) & (r1 | r2)] = 2

    agg = np.full(n, -1, np.int64)
    ri = np.flatnonzero(state == 1)
    agg[ri] = np.arange(len(ri))
    # roots absorb strong neighbors (conflicts -> min root id, deterministic)
    root_of = np.full(n, np.iinfo(np.int64).max)
    root_of[ri] = agg[ri]
    nb_root = root_of[indices]
    nz = np.flatnonzero(deg > 0)
    mn = np.minimum.reduceat(nb_root, indptr[nz])
    unagg = agg < 0
    take = unagg[nz] & (mn < np.iinfo(np.int64).max)
    agg[nz[take]] = mn[take]
    # two sweeps: attach stragglers to any aggregated strong neighbor
    for _ in range(2):
        cur = np.where(agg >= 0, agg, np.iinfo(np.int64).max)
        nbm = cur[indices]
        mn = np.full(n, np.iinfo(np.int64).max)
        mn[nz] = np.minimum.reduceat(nbm, indptr[nz])
        fill = (agg < 0) & (mn < np.iinfo(np.int64).max)
        agg[fill] = mn[fill]
    # singletons
    rest = np.flatnonzero(agg < 0)
    na = int(agg.max()) + 1 if (agg >= 0).any() else 0
    agg[rest] = na + np.arange(len(rest))
    na = int(agg.max()) + 1
    # relabel by first fine node (locality)
    first = np.full(na, n, np.int64)
    np.minimum.at(first, agg, np.arange(n))
    order = np.argsort(first, kind="stable")
    relabel = np.empty(na, np.int64)
    relabel[order] = np.arange(na)
    return relabel[agg], na


def _default_candidates(n, bs):
    """Per-component constants (the bs translation modes)."""
    B = np.zeros((n, bs))
    for c in range(bs):
        B[c::bs, c] = 1.0
    return B


def _fit_candidates(agg, na, B, bs, tol=1e-8):
    """Per-aggregate QR of the near-nullspace candidates (PyAMG-style
    fit_candidates): returns the tentative prolongator T (n x na*k) with
    orthonormal within-aggregate column blocks, and the coarse candidates
    Bc (na*k, k) = stacked R factors, so T @ Bc == B up to dropped
    rank-deficient columns (singleton aggregates cannot represent all 6
    rigid modes — their dependent columns are zeroed, which decouples the
    corresponding coarse dofs; the coarse solve's diagonal shift keeps them
    harmless).

    QR is batched, BUCKETED by padded aggregate size so one giant aggregate
    does not blow up the (na, m_max, k) workspace."""
    import scipy.sparse as sp

    n_nodes = agg.shape[0]
    n, k = B.shape
    assert n == n_nodes * bs, (n, n_nodes, bs)
    sizes = np.bincount(agg, minlength=na)
    order = np.argsort(agg, kind="stable")
    starts = np.zeros(na + 1, np.int64)
    np.cumsum(sizes, out=starts[1:])
    pos_node = np.arange(n_nodes) - starts[agg[order]]  # rank within agg

    # bucket aggregates by padded dof count (next power of two, >= k rows
    # so reduced QR always yields k columns)
    m_dofs = np.maximum(sizes * bs, 1)
    bucket = np.maximum(
        (2 ** np.ceil(np.log2(m_dofs))).astype(np.int64), k)
    rows_l, cols_l, vals_l = [], [], []
    Bc = np.zeros((na, k, k))
    agg_sorted = agg[order]
    for mb in np.unique(bucket):
        asel = np.flatnonzero(bucket == mb)
        loc = np.full(na, -1, np.int64)
        loc[asel] = np.arange(asel.size)
        in_b = loc[agg_sorted] >= 0
        nd = order[in_b]                      # nodes of this bucket
        arow = loc[agg_sorted[in_b]]          # aggregate idx within bucket
        prow = pos_node[in_b]                 # node rank within aggregate
        dof_rows = (nd[:, None] * bs + np.arange(bs)).ravel()
        dof_arow = np.repeat(arow, bs)
        dof_prow = (prow[:, None] * bs + np.arange(bs)).ravel()
        Bp = np.zeros((asel.size, mb, k))
        Bp[dof_arow, dof_prow] = B[dof_rows]
        Q, R = np.linalg.qr(Bp)               # (nb, mb, k), (nb, k, k)
        # rank safeguard: zero columns whose R diagonal is negligible
        # (Q columns beyond the rank are arbitrary orthonormal fill that
        # would otherwise leak garbage into P)
        dR = np.abs(np.einsum("aii->ai", R))
        bad = dR < tol * np.maximum(dR.max(axis=1, keepdims=True), 1e-300)
        if bad.any():
            Q = np.where(bad[:, None, :], 0.0, Q)
            R = np.where(bad[:, :, None], 0.0, R)
        rows_l.append(np.repeat(dof_rows, k))
        cols_l.append(
            (np.repeat(agg_sorted[in_b], bs)[:, None] * k
             + np.arange(k)).ravel())
        vals_l.append(Q[dof_arow, dof_prow].ravel())
        Bc[asel] = R
    T = sp.csr_matrix(
        (np.concatenate(vals_l),
         (np.concatenate(rows_l), np.concatenate(cols_l))),
        shape=(n, na * k))
    T.eliminate_zeros()
    return T, Bc.reshape(na * k, k)


def _rho_dinv_a(A, n_iter=30, seed=1):
    """Upper estimate of rho(D^-1 A) = lambda_max(D^-1/2 A D^-1/2): Lanczos
    on the symmetrized operator with a Gershgorin safety cap.

    The Chebyshev smoother DIVERGES on any mode above its `hi` bound, so an
    underestimate is a correctness bug, not a quality knob: the original
    10-step power iteration (1.05 margin) undershot lambda_max on the 74k-dof
    f32 contact operator and the compounded V-cycle amplification drove CG to
    NaN at it=48 (same failure class as the lattice GMG's fixed omega=0.8).
    Lanczos converges to the extreme eigenvalue far faster than the power
    method on clustered spectra, but Ritz values are still LOWER bounds, so
    the 1.1x margin on top of 30 Lanczos steps is a heuristic, not a
    guarantee; the Gershgorin min only prevents over-estimation.  The
    caller stacks another 1.1x at the Chebyshev `hi` (smoothed_aggregation_
    amg: cheb = 1.1*rho), giving ~1.21x total margin over the Ritz value —
    no failure observed across the contact/elasticity operators since the
    Lanczos switch."""
    d = A.diagonal()
    dinv = _safe_inv(d)
    # Gershgorin row bound of D^-1 A: a guaranteed upper bound on rho
    absA = abs(A)
    gersh = float((np.abs(dinv) * np.ravel(absA.sum(axis=1))).max())
    if gersh == 0.0:
        return 1.0
    # Lanczos on D^-1/2 A D^-1/2 (same spectrum, symmetric -> tridiagonal
    # Ritz values are tight lower bounds on lambda_max)
    sq = np.sqrt(np.abs(dinv))
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    alphas, betas = [], []
    v_prev = np.zeros_like(v)
    beta = 0.0
    for _ in range(min(n_iter, A.shape[0])):
        w = sq * (A @ (sq * v)) - beta * v_prev
        alpha = float(v @ w)
        w -= alpha * v
        alphas.append(alpha)
        beta = float(np.linalg.norm(w))
        if beta < 1e-12:
            break
        betas.append(beta)
        v_prev, v = v, w / beta
    T = np.diag(alphas)
    if betas:
        k = len(alphas)
        T = T + np.diag(betas[: k - 1], 1) + np.diag(betas[: k - 1], -1)
    lmax = float(np.linalg.eigvalsh(T).max()) if len(alphas) else 1.0
    return float(min(max(lmax, 1e-12) * 1.1, gersh))


def _to_device_op(A, dtype, bs=1, device=None, ell_min=4096):
    """scipy -> device operator: block-ELL on a CUDA device for large
    matrices, CSR else (the JAX package's accelerator / host branches)."""
    from .ell import ell_from_scipy
    from .sparse import csr_from_scipy

    if max(A.shape) >= ell_min and device.type == "cuda":
        return ell_from_scipy(A, br=bs, dtype=dtype, k_quantile=99.5, device=device)
    return csr_from_scipy(A, dtype=dtype, device=device)


def smoothed_aggregation_amg(
    A, bs=1, theta=0.08, max_levels=12, coarse_size=800,
    n_smooth=3, dtype=np.float32, seed=0, fine_op=None, nullspace=None, device=DEFAULT_DEVICE,
):
    """Build an AMG preconditioner on `device` from a scipy sparse matrix
    (or any operator exposing .to_scipy()).

    bs: dof block size (3 for 3D elasticity) — aggregation runs on the node
    graph; the tentative prolongator comes from per-aggregate QR of the
    near-nullspace candidates.

    nullspace: optional (n, k) candidate matrix — pass
    utils.mpc_utils.rigid_motions_nullspace(V) for elasticity (6 rigid
    modes in 3D).  Default: the bs translation modes.  Coarse levels then
    carry block size k.

    fine_op: optional pre-built device operator for the FINE level (the
    caller's CG operator is the same matrix; sharing it halves the
    fine-level device memory)."""
    import math

    import scipy.sparse as sp

    dev = resolve_device(device)
    if hasattr(A, "to_scipy"):
        A = A.to_scipy()
    A = A.tocsr()

    if nullspace is not None:
        Bl = np.asarray(nullspace, np.float64)
        assert Bl.shape[0] == A.shape[0], (Bl.shape, A.shape)
    else:
        Bl = _default_candidates(A.shape[0], bs)
    k = Bl.shape[1]

    ops, Ps, Rs, chebs, level_bs = [], [], [], [], []
    lvl = 0
    Al = A
    bs_l = bs
    while Al.shape[0] > coarse_size and lvl < max_levels - 1:
        G = _node_graph(Al, bs_l)
        # adaptive strength threshold: halve theta until aggregates average
        # >= ~3 nodes (a stalled level otherwise emits ~1 singleton aggregate
        # per node); only stalled levels relax
        n_nodes = G.shape[0]
        th = theta
        for _ in range(5):
            S = _strength(G, th)
            agg, na = _aggregate(S, seed=seed + lvl)
            if na <= n_nodes // 3:
                break
            th *= 0.5
        if na * k >= Al.shape[0]:  # no coarsening progress even at th->0
            break
        # tentative prolongator + projected coarse candidates
        T, Bc = _fit_candidates(agg, na, Bl, bs_l)
        # smoothed P = (I - omega D^-1 A) T,  omega = 4/3 / rho(D^-1 A)
        rho = _rho_dinv_a(Al)
        d = Al.diagonal()
        dinv = _safe_inv(d)
        omega = (4.0 / 3.0) / rho
        P = (T - sp.diags(omega * dinv) @ (Al @ T)).tocsr()
        P.eliminate_zeros()
        R = P.T.tocsr()
        Ac = (R @ Al @ P).tocsr()
        Ac.eliminate_zeros()
        ops.append(Al)
        Ps.append(P)
        Rs.append(R)
        chebs.append(rho)
        level_bs.append(bs_l)
        Al = Ac
        Bl = Bc
        bs_l = k
        lvl += 1

    ops.append(Al)
    level_bs.append(bs_l)
    dev_ops = [fine_op if (i == 0 and fine_op is not None)
               else _to_device_op(a, dtype, level_bs[i], dev)
               for i, a in enumerate(ops[:-1])]
    # transfers are (level_bs[i] x k)-blocked rectangles: the ELL block
    # size must divide BOTH dims, so use gcd(fine bs, coarse bs)
    t_bs = [math.gcd(level_bs[i], level_bs[i + 1]) for i in range(len(Ps))]
    dev_P = [_to_device_op(p, dtype, t_bs[i], dev) for i, p in enumerate(Ps)]
    dev_R = [_to_device_op(r, dtype, t_bs[i], dev) for i, r in enumerate(Rs)]
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a.astype(dtype)), device=dev)  # noqa: E731
    inv_diag = [as_t(_safe_inv(a.diagonal())) for a in ops[:-1]]
    # explicit dense inverse of the coarsest level (one matmul in the
    # V-cycle): Cholesky-solve against I with a tiny diagonal shift, pinv as
    # the fallback for genuinely singular coarse operators
    nC = ops[-1].shape[0]
    if nC <= 16384:
        Ad = np.asarray(ops[-1].todense(), dtype=np.float64)
        try:
            import scipy.linalg as sla

            shift = 1e-10 * (np.trace(Ad) / max(nC, 1))
            c_lo = sla.cho_factor(Ad + shift * np.eye(nC), lower=True)
            coarse_dense = sla.cho_solve(c_lo, np.eye(nC))
        except Exception:
            coarse_dense = np.linalg.pinv(Ad)
        coarse_inv = as_t(coarse_dense)
    else:
        # aggregation stalled with a large coarsest level: terminate the
        # V-cycle with Chebyshev smoothing on that level instead
        d = ops[-1].diagonal()
        dev_ops.append(_to_device_op(ops[-1], dtype, level_bs[-1], dev))
        inv_diag.append(as_t(_safe_inv(d)))
        chebs.append(_rho_dinv_a(ops[-1]))
        coarse_inv = None
    cheb = [(rho / 20.0, 1.1 * rho) for rho in chebs]
    return AMG(dev_ops, dev_P, dev_R, inv_diag, coarse_inv, cheb, degree=n_smooth)


# --------------------------------------------------------------- V-cycle ---

class AMG:
    """Smoothed-aggregation V-cycle: a callable r -> M r on the levels'
    device."""

    def __init__(self, ops, Ps, Rs, inv_diag, coarse_inv, cheb, degree=3):
        self.ops = ops
        self.Ps = Ps
        self.Rs = Rs
        self.inv_diag = inv_diag
        self.coarse_inv = coarse_inv
        self.cheb = cheb  # (lo, hi) spectrum bounds of D^-1 A per level
        self.degree = degree

    def _smooth(self, lvl, x, b):
        """Chebyshev iteration on D^-1 A over [lo, hi] (hypre-style)."""
        A = self.ops[lvl]
        dinv = self.inv_diag[lvl]
        lo, hi = self.cheb[lvl]
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        rho = 1.0 / sigma
        r = b - A.matvec(x)
        d = (dinv * r) / theta
        for _ in range(self.degree):
            x = x + d
            r = r - A.matvec(d)
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * (dinv * r)
            rho = rho_new
        return x

    def _vcycle(self, lvl, b):
        if lvl == len(self.Ps):
            if self.coarse_inv is not None:
                return torch.matmul(self.coarse_inv, b)
            # no dense coarse inverse (coarsest level too large): two
            # Chebyshev sweeps approximate the coarse solve
            x = self._smooth(lvl, torch.zeros_like(b), b)
            return self._smooth(lvl, x, b)
        x = self._smooth(lvl, torch.zeros_like(b), b)
        r = b - self.ops[lvl].matvec(x)
        xc = self._vcycle(lvl + 1, self.Rs[lvl].matvec(r))
        x = x + self.Ps[lvl].matvec(xc)
        return self._smooth(lvl, x, b)

    def __call__(self, r):
        return self._vcycle(0, r)
