"""Geometric multigrid preconditioner for lattice operators (torch).

Counterpart of ``dolfinx_mpc_tpu/la/gmg.py``.  Every level is a
LatticeOperator re-discretized on the coarsened box mesh (or, for degree 2,
p-coarsened first: level 1 is the P1 operator on the same refined grid),
smoothing is weighted Jacobi or Chebyshev-Jacobi, the transfers are linear
interpolation / full weighting as strided slicing on the vertex grid with
R = P^T, and the coarsest level is solved with a dense inverse.  The whole
cycle is a fixed linear symmetric operator, as plain CG requires.  All
level matvecs, the smoothers' and the Gershgorin bounds', go through the
level operators' SpMV: kernel K2 on the card for scalar DIA levels, K7 for
vector (bs > 1) ones, K6 for a blocked fine level.  Vector levels keep the
components interleaved and transfer each component alike.  With
``blocked_io`` the fine level works on the padded class stack of its
BlockDIAMatrix, converting at the level-0/1 transfer.  Levels may be of
any side format ("fold", "csr", "cells"): their matvec and diagonal carry
the side blocks, and so does the Gershgorin bound.  The JAX package's
constructor options are all accepted, with its defaults, the legacy
inner-CG coarse solve (coarse="cg") among them.  On the card the cycle is
captured once per input layout as a CUDA graph and replayed (LatticeGMG).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..ops.lattice_kernels import blocked_matvec, dia_matvec, dia_matvec_bs
from ..utils.timing import span
from .cycle_graph import CycleGraph as _Graph  # noqa: F401  (a graph table's entries)
from .cycle_graph import run_cycle
from .solvers import ChebyshevPC

__all__ = ["LatticeGMG", "build_gmg_hierarchy", "dense_coarse_inverse"]


def _along(axis, ndim, s):
    return tuple(s if a == axis else slice(None) for a in range(ndim))


def _restrict1(x, axis):
    """Full-weighting along one axis: size 2m+1 -> m+1."""
    e = x[_along(axis, x.ndim, slice(0, None, 2))]  # (m+1,)
    o = x[_along(axis, x.ndim, slice(1, None, 2))]  # (m,)
    zero = torch.zeros_like(o.narrow(axis, 0, 1))
    return 0.5 * e + 0.25 * (torch.cat([zero, o], dim=axis) + torch.cat([o, zero], dim=axis))


def _prolong1(c, axis):
    """Linear interpolation along one axis: size m+1 -> 2m+1."""
    m1 = c.shape[axis]
    mid = 0.5 * (c.narrow(axis, 0, m1 - 1) + c.narrow(axis, 1, m1 - 1))
    shape = list(c.shape)
    shape[axis] = 2 * m1 - 1
    out = torch.empty(shape, dtype=c.dtype, device=c.device)
    out[_along(axis, c.ndim, slice(0, None, 2))] = c
    out[_along(axis, c.ndim, slice(1, None, 2))] = mid
    return out


def _abs_rowsum(A):
    """Upper bound on |A| . 1 per row (the Gershgorin numerator): the flat
    matvec of the operator's entrywise |A| (LatticeOperator.abs) on
    all-ones (dolfinx_mpc_tpu/la/gmg.py:58-79).  Real for a complex
    operator too, as in the JAX package (its ones in the real dtype, :70,
    :78)."""
    B = A.abs()
    return B.matvec(torch.ones(A.shape[0], dtype=B.dtype, device=A.device))


def _gershgorin_bounds(ops, inv_diags):
    """lmax(D^-1 A) upper bounds for every level."""
    return [float(torch.max(torch.abs(_abs_rowsum(A) * inv))) for A, inv in zip(ops, inv_diags)]


def _chebyshev(mv, inv, bound, lmin_frac, degree):
    """Chebyshev-Jacobi of `degree` (ChebyshevPC) on [lmin_frac, 1] * lmax
    of D^-1 A, lmax = 1.05 * the Gershgorin bound."""
    return ChebyshevPC(lambda v: inv * mv(v), inv, 1.05 * max(bound, 1e-30), lmin_frac, degree)


def dense_coarse_inverse(A):
    """Materialize the coarsest operator densely (from its host CSR form)
    and invert it on the host with a Cholesky factorization: in float64
    for a real operator, in complex128 for a complex one (its Hermitian
    part (C + C^H) / 2, a complex Cholesky).  The result makes the coarse
    solve a single dense matvec — exact, linear and self-adjoint.  An
    indefinite C (rounding noise) gets its eigenvalues clipped instead.

    The JAX package casts C to float64 whatever its dtype
    (dolfinx_mpc_tpu/la/gmg.py:113), which drops the imaginary part of a
    complex coarse operator (a Bloch phase's) and preconditions with the
    inverse of its real part; the port keeps it (ROADMAP queue 3).  A
    real operator's inverse is the same, bit for bit, as before complex
    operators were taken."""
    import scipy.linalg as sla

    nd = A.shape[0]
    C = np.asarray(A.to_scipy().toarray(), np.complex128 if A.dtype.is_complex else np.float64)
    C = 0.5 * (C + C.conj().T)
    try:
        inv = sla.cho_solve(sla.cho_factor(C), np.eye(nd))
    except np.linalg.LinAlgError:
        # indefinite numerical noise: clip the spectrum instead of failing
        w, Q = np.linalg.eigh(C)
        w = np.maximum(w, 1e-12 * np.abs(w).max())
        inv = (Q / w) @ Q.conj().T
    inv = 0.5 * (inv + inv.conj().T)
    return torch.as_tensor(inv, dtype=A.dtype, device=A.device)


class LatticeGMG:
    """Symmetric V-cycle over a list of LatticeOperators (fine -> coarse),
    with the JAX package's constructor (dolfinx_mpc_tpu/la/gmg.py:146-240).

    Smoothing is weighted Jacobi or a degree-(n_sweeps+1) Chebyshev-Jacobi
    polynomial on [lmax/4, lmax] of D^-1 A (ChebyshevPC, applied to the
    residual), with equal pre/post sweeps; transfers satisfy R = P^T.
    omega="auto" damps Jacobi by 1.6 / max(lmax, 2) per level, lmax the
    Gershgorin bound of D^-1 A (a number applies to every level).  bounds:
    precomputed per-level bounds (computed when omega, the smoother or the
    coarse solve needs them and none are given).  coarse: "auto" (a dense
    inverse up to dense_max dofs, else Chebyshev), "dense" (coarse_inv if
    given, else the coarsest operator inverted on the host), "chebyshev"
    (a fixed degree-cheb_degree polynomial on [lmax/64, lmax] of D^-1 A) or
    "cg": the legacy inner solve, coarse_iters Jacobi-CG iterations.  The
    other modes keep the cycle a fixed linear symmetric operator, as plain
    CG requires; "cg" does not — an inner Krylov solve is nonlinear and
    slightly nonsymmetric, valid only under a flexible outer method, and
    the JAX package measured it stalling its bs=3 elasticity CG in float32.

    blocked_io: the fine level works on the padded class stack (n_cls, s0,
    s1, s2) of its BlockDIAMatrix — __call__ takes and returns that layout,
    the smoother runs matvec_blocked, and the stack converts to and from the
    flat vector only at the level-0/1 transfer.  Left False over a blocked
    fine level, the cycle takes flat vectors and every fine matvec converts
    (CG on ``A.matvec``, as tests/test_gmg.py compares with blocked I/O).

    On a CUDA input the cycle runs as a CUDA graph (la/cycle_graph.py), one
    per input layout in _graphs: captured once, then replayed (K2, K6, K7
    and the same elementwise kernels, without their ~1,000 host launches),
    with the counters gmg.graph_capture and gmg.graph_replay, and each
    replay re-adding one cycle's span calls and K2 / K6 / K7 launch counts.
    A graph reads the level tensors in place, as the operators' prepared
    launches do: the hierarchy is fixed once built.  A CPU input
    takes the eager cycle.  tail(l) is the cycle over levels l, l+1, ... of
    the same hierarchy (the sharded path's replicated part), sharing its
    levels and capturing graphs of its own."""

    def __init__(self, ops, n_pre=2, n_post=2, omega="auto", coarse_iters=30, free_masks=None, coarse="auto",
                 coarse_inv=None, dense_max=8192, cheb_degree=40, bounds=None, blocked_io=False,
                 smoother="jacobi"):
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(f"unknown smoother {smoother!r}")
        if coarse not in ("auto", "dense", "chebyshev", "cg"):
            raise ValueError(f"unknown coarse mode {coarse!r}")
        if blocked_io and not ops[0].supports_blocked():
            raise ValueError("blocked_io: the fine operator has no blocked layout")
        if blocked_io and len(ops) < 2:
            raise ValueError("blocked_io needs a coarse level")
        for Af, Ac in zip(ops[:-1], ops[1:]):
            for nf, ncs in zip(Af.dia.vshape, Ac.dia.vshape):
                if not (nf == ncs or nf == 2 * ncs - 1):
                    raise ValueError(f"levels do not nest: {Af.dia.vshape} -> {Ac.dia.vshape}")
        self.ops = ops
        self.n_pre, self.n_post = n_pre, n_post
        self.coarse_iters = coarse_iters
        self.smoother = smoother
        self.blocked_io = blocked_io
        # free_masks[l]: 1 on unconstrained dofs, 0 on bc/slave rows —
        # residuals/corrections are projected onto the free subspace around
        # each transfer so constrained rows don't pollute coarse levels
        if blocked_io and free_masks is not None:
            free_masks = [ops[0].to_blocked(free_masks[0])] + list(free_masks[1:])
        self.free_masks = free_masks
        inv = lambda d: torch.where(d != 0, 1.0 / d, torch.zeros_like(d))  # noqa: E731
        flat_inv = [inv(A.diagonal()) for A in ops]
        self._inv_diag = list(flat_inv)
        if blocked_io:
            self._inv_diag[0] = inv(ops[0].diagonal_blocked())
        # per-level Gershgorin bound lmax(D^-1 A) <= max_i sum_j |a_ij| / d_i
        # (from the flat matvec and inverse diagonal on every level):
        # weighted-Jacobi damping keeps omega * lmax < 2 (Poisson lmax = 2 ->
        # the classic 0.8), the Chebyshev polynomials work on [lmax/4, lmax]
        if bounds is None and (omega == "auto" or coarse in ("auto", "chebyshev") or smoother == "chebyshev"):
            bounds = _gershgorin_bounds(ops, flat_inv)
        self._bounds = bounds
        self.omegas = (tuple(1.6 / max(b, 2.0) for b in bounds) if omega == "auto"
                       else (float(omega),) * len(ops))
        # the Chebyshev smoother: one polynomial per level and sweep count
        self._smoothers = ([{n: _chebyshev(self._mv(lvl), self._inv_diag[lvl], bounds[lvl], 1 / 4, n + 1)
                             for n in {n_pre, n_post}} for lvl in range(len(ops) - 1)]
                           if smoother == "chebyshev" else None)
        if coarse == "auto":
            coarse = "dense" if ops[-1].shape[0] <= dense_max else "chebyshev"
        self.coarse_mode = coarse
        self.coarse_inv = None
        self._coarse_cheb = None
        if coarse == "dense":
            self.coarse_inv = (dense_coarse_inverse(ops[-1]) if coarse_inv is None
                               else torch.as_tensor(coarse_inv, dtype=ops[-1].dtype, device=ops[-1].device))
        elif coarse == "chebyshev":
            self._coarse_cheb = _chebyshev(ops[-1].matvec, self._inv_diag[-1], bounds[-1], 1 / 64, int(cheb_degree))
        # the V-cycle's span names (utils/timing.py), made once: pre, down,
        # up, post per level above the coarsest
        self._span_names = [tuple(f"gmg.L{lvl}.{phase}" for phase in ("pre", "down", "up", "post"))
                            for lvl in range(len(ops) - 1)]
        self._graphs = {}  # (shape, dtype, device) -> CycleGraph (la/cycle_graph.py)

    def tail(self, start):
        """The V-cycle over levels start, start+1, ... of this hierarchy, on
        flat vectors unless start is 0: it shares their operators, inverse
        diagonals, damping, smoothers, masks and coarse solve, keeps their
        span names (gmg.L<start>.* first) and captures graphs of its own."""
        if not 0 <= start < len(self.ops):
            raise ValueError(f"tail({start}) of a {len(self.ops)}-level hierarchy")
        t = copy.copy(self)
        for name in ("ops", "free_masks", "_inv_diag", "omegas", "_bounds", "_smoothers", "_span_names"):
            v = getattr(self, name)
            setattr(t, name, None if v is None else v[start:])
        t.blocked_io = self.blocked_io and start == 0
        t._graphs = {}
        return t

    def _to_grid(self, A, x):
        n0, n1, n2 = A.dia.vshape
        return x.reshape(n0, n1, n2, A.dia.bs)

    def _mv(self, lvl):
        A = self.ops[lvl]
        return A.matvec_blocked if lvl == 0 and self.blocked_io else A.matvec

    def _smooth(self, lvl, x, b, n_sweeps):
        mv = self._mv(lvl)
        if self._smoothers is not None:
            return x + self._smoothers[lvl][n_sweeps](b - mv(x))
        om, inv = self.omegas[lvl], self._inv_diag[lvl]
        for _ in range(n_sweeps):
            x = x + om * inv * (b - mv(x))
        return x

    def _restrict(self, lvl, r):
        # R = P^T exactly (x2 per coarsened axis on top of full weighting)
        Af, Ac = self.ops[lvl], self.ops[lvl + 1]
        if lvl == 0 and self.blocked_io:
            r = Af.from_blocked(r)  # class stack -> fine nodal flat
        g = self._to_grid(Af, r)
        for ax in range(3):
            if Af.dia.vshape[ax] != Ac.dia.vshape[ax]:
                g = 2.0 * _restrict1(g, ax)
        return g.reshape(-1)

    def _prolong(self, lvl, xc):
        Af, Ac = self.ops[lvl], self.ops[lvl + 1]
        g = self._to_grid(Ac, xc)
        for ax in range(3):
            if Af.dia.vshape[ax] != Ac.dia.vshape[ax]:
                g = _prolong1(g, ax)
        g = g.reshape(-1)
        if lvl == 0 and self.blocked_io:
            g = Af.to_blocked(g)  # fine nodal flat -> class stack
        return g

    def _coarse_solve(self, b):
        if self.coarse_mode == "dense":
            return self.coarse_inv @ b
        if self.coarse_mode == "cg":
            return self._coarse_cg(self.ops[-1], self._inv_diag[-1], b)
        return self._coarse_cheb(b)

    def _coarse_cg(self, A, inv, b):
        """coarse_iters Jacobi-CG iterations from zero
        (dolfinx_mpc_tpu/la/gmg.py:348-368): nonlinear in b."""
        x = torch.zeros_like(b)
        r = b
        z = inv * r
        p = z
        rz = torch.vdot(r, z)
        for _ in range(self.coarse_iters):
            Ap = A.matvec(p)
            pAp = torch.vdot(p, Ap)
            alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
            x = x + alpha * p
            r = r - alpha * Ap
            z = inv * r
            rzn = torch.vdot(r, z)
            p = z + (rzn / torch.where(rz == 0, torch.ones_like(rz), rz)) * p
            rz = rzn
        return x

    def _mask(self, lvl, v):
        if self.free_masks is None:
            return v
        return v * self.free_masks[lvl]

    def _vcycle(self, lvl, b):
        # each span holds its own phase only: the recursion into lvl + 1
        # lies between the "down" and "up" spans of lvl
        if lvl == len(self.ops) - 1:
            with span("gmg.coarse"):
                return self._coarse_solve(b)
        pre, down, up, post = self._span_names[lvl]
        with span(pre):
            x = self._smooth(lvl, torch.zeros_like(b), b, self.n_pre)
        with span(down):
            r = self._mask(lvl, b - self._mv(lvl)(x))
            rc = self._mask(lvl + 1, self._restrict(lvl, r))
        xc = self._vcycle(lvl + 1, rc)
        with span(up):
            x = x + self._mask(lvl, self._prolong(lvl, self._mask(lvl + 1, xc)))
        with span(post):
            return self._smooth(lvl, x, b, self.n_post)

    def __call__(self, r):
        return run_cycle(self._graphs, lambda v: self._vcycle(0, v), r, "gmg",
                         (dia_matvec, dia_matvec_bs, blocked_matvec))


def build_gmg_hierarchy(make_compiled_form, n, n_levels, min_n=4, levels=None):
    """Build ([finest ... coarsest] LatticeOperators, free-dof masks) by
    re-discretization.

    make_compiled_form(n) must return a CompiledLatticeForm for mesh
    resolution n (same physics, bcs and constraints regenerated
    geometrically on each level).  levels: optional explicit list of level
    descriptors passed verbatim to make_compiled_form (finest first); when
    omitted, levels are n, n/2, n/4, ... down to min_n.  Each mask lives
    on its level's device in the real dtype of its operator (the JAX
    package's masks are real too)."""
    if levels is None:
        levels, nl = [], n
        for _ in range(n_levels):
            if nl < min_n:
                break
            levels.append(nl)
            if nl % 2:
                break  # odd level: no further 2:1 coarsening
            nl >>= 1
    ops, masks = [], []
    for lv in levels:
        clf = make_compiled_form(lv)
        op = clf.assemble()
        ops.append(op)
        m = np.ones(clf.V.num_dofs)
        m[np.asarray(clf.bc_dofs, np.int64)] = 0.0
        if clf.mpc is not None and clf.mpc.num_local_slaves:
            m[np.asarray(clf.mpc.slaves)] = 0.0
        masks.append(torch.as_tensor(m, dtype=op.dtype.to_real(), device=op.device))
    return ops, masks
