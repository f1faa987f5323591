"""Symmetric generalized eigensolver: shift-and-invert subspace iteration
(torch).

Counterpart of ``dolfinx_mpc_tpu/la/eig.py``.  The inverse of
(A - sigma M) is applied by a batched preconditioned CG over the whole
search block, with per-column step lengths and frozen converged columns;
the small (m, m) Rayleigh-Ritz problem is solved on the host with numpy:

    X <- M-orthonormal block of size m = nev + guard
    repeat:
        Y   <- (A - sigma*M)^{-1} (M X)        batched CG
        Y   <- M-orthonormalize(Y)             block Cholesky in the M metric
        Hp  <- Y^H A Y                         Rayleigh-Ritz on the pencil
        X   <- Y @ eigvecs(Hp)
    until residuals ||A x - lam M x|| small for the nev wanted pairs

The JAX package batches its matvecs with ``jax.vmap``; ``torch.vmap``
cannot batch the port's CSR product (its ``index_add_`` into an unbatched
output), so an operator is applied to a column block through its
``matmat`` where it has one (``CSRMatrix``, ``JacobiPC``) and column by
column otherwise (BELL: one K8 launch per column; DIA and lattice
operators: one K2/K7 launch per column; plain callables).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["eigsh_shift_invert"]


def _as_matvec(A) -> Callable:
    return A.matvec if hasattr(A, "matvec") else A


def _block(A) -> Callable:
    """X (n, k) -> A X: A.matmat, else A's matvec on each column."""
    if hasattr(A, "matmat"):
        return A.matmat
    mv = _as_matvec(A)
    return lambda X: torch.stack([mv(X[:, j].contiguous()) for j in range(X.shape[1])], dim=1)


def _cdot(u, v):
    """Per-column <u, v>: (k,)."""
    return torch.sum(torch.conj(u) * v, dim=0)


def _block_cg(Ab: Callable, B, Mb: Callable = None, rtol=1e-10, atol=1e-14, max_it=5000):
    """Batched preconditioned CG: solve A x_j = b_j for every column of B
    (n, k) with per-column step lengths; converged columns freeze (their
    step is 0), so a hard column cannot destabilize an easy one.  Ab and Mb
    act on column blocks.  Returns (X, iterations); one host read per
    iteration."""
    if Mb is None:
        Mb = lambda R: R  # noqa: E731
    X = torch.zeros_like(B)
    R = B
    Z = Mb(R)
    P = Z
    rz = _cdot(R, Z)
    tol2 = torch.clamp(rtol * torch.sqrt(_cdot(B, B).real), min=atol) ** 2
    one = torch.ones((), dtype=B.dtype, device=B.device)
    zero = torch.zeros((), dtype=B.dtype, device=B.device)
    k = 0
    while k < max_it:
        act = _cdot(R, R).real > tol2
        if not bool(act.any()):
            break
        AP = Ab(P)
        pAp = _cdot(P, AP)
        alpha = torch.where(act, rz / torch.where(act, pAp, one), zero)
        X = X + alpha[None, :] * P
        R = R - alpha[None, :] * AP
        Z = Mb(R)
        rz_new = _cdot(R, Z)
        beta = torch.where(act, rz_new / torch.where(act, rz, one), zero)
        P = Z + beta[None, :] * P
        rz = rz_new
        k += 1
    return X, k


def _m_orthonormalize(X, Mb):
    """Block Gram-Schmidt in the M inner product via the Cholesky factor of
    the Gram matrix (one (n, m) x (m, m) product, no per-vector loop)."""
    G = X.conj().T @ Mb(X)
    # jitter for near-rank-deficient blocks (random X0 never needs it; Ritz
    # rotations after convergence can)
    eps = 1e-14 * torch.trace(G).real / G.shape[0]
    L = torch.linalg.cholesky(G + eps * torch.eye(G.shape[0], dtype=G.dtype, device=G.device))
    return torch.linalg.solve_triangular(L, X.conj().T, upper=False).conj().T


def _operator_placement(*ops):
    """(dtype, device) of the first operator that holds a tensor (.data) or
    names its own (.dtype / .device, as MatrixFreeKTAK and BellMatrix do);
    (None, None) for plain callables."""
    from .._dtypes import torch_dtype

    for op in ops:
        data = getattr(op, "data", None)
        if isinstance(data, torch.Tensor):
            return data.dtype, data.device
        dev = getattr(op, "device", None)
        if dev is not None:
            dt = getattr(op, "dtype", None)
            return (None if dt is None else torch_dtype(dt)), torch.device(dev)
    return None, None


def eigsh_shift_invert(A, M, nev: int, sigma: float = 0.0, X0=None, pc: Optional[Callable] = None,
                       tol: Optional[float] = None, max_outer: int = 40, inner_rtol: Optional[float] = None,
                       inner_max_it: int = 5000, guard: Optional[int] = None, seed: int = 0, device=None):
    """Smallest-|lam - sigma| eigenpairs of the symmetric pencil
    A x = lam M x (A - sigma*M SPD near sigma; M SPD).

    A, M: matvec callables or objects with .matvec (and .shape, unless X0
    is given; a .matmat is used where they have one).
    pc: optional preconditioner for the inner (A - sigma M) solves, e.g.
        ``jacobi_preconditioner`` of A's diagonal.
    X0: optional (n, m) start block (tensor or array); else a standard
        normal block from numpy's default_rng(seed).
    The start block goes to `device` if it is given; else a tensor X0 stays
    where it is, and otherwise the block takes the device (and, when X0 is
    not given, the dtype) of A's or M's data (.data, or .device / .dtype),
    and for plain callables the port's default device, the card (float64).
    Default tolerances follow the dtype: float64 tol 1e-8, inner_rtol
    1e-10; float32 tol 2e-4, inner_rtol 1e-6.
    Returns (lam (nev,) numpy, U (n, nev) tensor, info dict with the outer
    iterations, the total inner CG iterations and the final residuals).
    """
    from .._device import resolve_device

    Ab, Mb = _block(A), _block(M)
    if sigma != 0.0:
        Kb = lambda X: Ab(X) - sigma * Mb(X)  # noqa: E731
    else:
        Kb = Ab
    Pb = None if pc is None else _block(pc)
    m = nev + (guard if guard is not None else max(2, nev))

    op_dtype, op_device = _operator_placement(A, M)
    if device is not None:
        device = resolve_device(device)
    elif isinstance(X0, torch.Tensor):
        device = X0.device
    else:
        device = op_device if op_device is not None else resolve_device(None)
    if X0 is not None:
        X = torch.as_tensor(X0, device=device)
        n = X.shape[0]
        if X.shape[1] < m:
            m = X.shape[1]
    else:
        shape = getattr(A, "shape", None) or getattr(M, "shape", None)
        if shape is None:
            raise ValueError("pass X0 or operators with .shape")
        n = shape[0]
        X = torch.as_tensor(np.random.default_rng(seed).standard_normal((n, m)),
                            dtype=op_dtype or torch.float64, device=device)
    single = X.dtype in (torch.float32, torch.complex64)
    if tol is None:
        tol = 2e-4 if single else 1e-8
    if inner_rtol is None:
        inner_rtol = 1e-6 if single else 1e-10

    X = _m_orthonormalize(X, Mb)
    lam = res = None
    inner_total = 0
    outer = 0
    for outer in range(max_outer):
        Y, k_in = _block_cg(Kb, Mb(X), Mb=Pb, rtol=inner_rtol, max_it=inner_max_it)
        inner_total += int(k_in)
        Y = _m_orthonormalize(Y, Mb)
        AY, MY = Ab(Y), Mb(Y)
        Hp = Y.conj().T @ AY
        # Ritz on the host: (m, m) symmetric dense
        w, c = np.linalg.eigh(((Hp + Hp.conj().T) / 2.0).cpu().numpy())
        order = np.argsort(np.abs(w - sigma))
        w, c = w[order], c[:, order]
        ct = torch.as_tensor(c, dtype=Y.dtype, device=Y.device)
        X = Y @ ct
        lam = w
        # residuals of the nev wanted pairs: ||A x - lam M x|| relative
        AYc = (AY @ ct[:, :nev]).cpu().numpy()
        MYc = (MY @ ct[:, :nev]).cpu().numpy()
        num = np.linalg.norm(AYc - MYc * w[:nev], axis=0)
        den = np.abs(w[:nev]) * np.linalg.norm(MYc, axis=0) + 1e-30
        res = num / den
        if (res < tol).all():
            break
    info = dict(outer=outer + 1, inner=inner_total, res=res)
    return lam[:nev], X[:, :nev], info
