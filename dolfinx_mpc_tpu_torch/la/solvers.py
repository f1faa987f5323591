"""Krylov solvers (torch): CG, BiCGStab and restarted GMRES with Jacobi,
Chebyshev-Jacobi or smoothed-aggregation AMG preconditioning.

Counterpart of ``dolfinx_mpc_tpu/la/solvers.py``.  The JAX package's
``lax.while_loop`` becomes a Python loop; the convergence test reads one
scalar back from the device per iteration (capturing the loop in a CUDA
graph is later work).  GMRES keeps its Krylov basis and the modified
Gram-Schmidt on the device and reads the new Hessenberg column back once
per iteration: the Givens rotations and the small triangular solve run on
the host, in the operands' dtype, with the JAX package's arithmetic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["SolverOptions", "cg", "bicgstab", "gmres", "JacobiPC", "jacobi_preconditioner",
           "chebyshev_preconditioner", "solve"]


@dataclass
class SolverOptions:
    """Mirror of the PETSc options dict surface (ksp_type/pc_type/rtol...)."""

    ksp_type: str = "cg"  # "cg" | "bcgs" | "gmres"
    # "none" | "jacobi" | "chebyshev" | "gamg" (aliases amg/hypre/boomeramg:
    # smoothed aggregation, la/amg.py)
    pc_type: str = "jacobi"
    rtol: float = 1e-8
    atol: float = 1e-12
    max_it: int = 10000
    cheb_degree: int = 3
    # start vector of the Chebyshev preconditioner's power iteration (None:
    # chebyshev_preconditioner's seeded default)
    cheb_probe: Optional[object] = None

    @classmethod
    def from_petsc(cls, opts: Optional[dict]):
        if opts is None:
            return cls()
        return cls(
            ksp_type=opts.get("ksp_type", "cg"),
            pc_type=opts.get("pc_type", "jacobi"),
            rtol=float(opts.get("ksp_rtol", 1e-8)),
            atol=float(opts.get("ksp_atol", 1e-12)),
            max_it=int(opts.get("ksp_max_it", 10000)),
        )


def _vdot(a, b):
    """conj(a) . b over all entries, whatever the shape (jnp.vdot flattens;
    torch.vdot takes only 1-D tensors)."""
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def cg(A: Callable, b, M: Callable = None, x0=None, rtol=1e-8, atol=1e-12, max_it=10000):
    """Preconditioned conjugate gradient.  A and M are linear operators
    (callables on tensors of b's shape: a flat vector or, on the degree-2
    path, the padded class stack).  Returns (x, iterations, residual_norm)
    with the last two as Python numbers."""
    if M is None:
        M = lambda r: r  # noqa: E731
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A(x)
    z = M(r)
    p = z
    rz = _vdot(r, z)
    tol2 = max(rtol * float(torch.linalg.vector_norm(b)), atol) ** 2
    k = 0
    while k < max_it and float(_vdot(r, r).real) > tol2:
        Ap = A(p)
        alpha = rz / _vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = _vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k, float(torch.linalg.vector_norm(r))


def bicgstab(A: Callable, b, M: Callable = None, x0=None, rtol=1e-8, atol=1e-12, max_it=10000):
    """Preconditioned BiCGStab (right preconditioning, the JAX package's
    recurrences).  Returns (x, iterations, residual_norm) with the last two
    as Python numbers.

    A breakdown, (r^, r) = 0 with r^ the shadow residual (the next step
    would divide by it), restarts the recurrences from the current iterate
    with r^ = r.  A step that leaves |r| or (r^, r) non-finite (a
    near-breakdown that overflowed) is undone: the recurrences restart the
    same way from the iterate before it, and if the first step after a
    restart is non-finite too, FloatingPointError is raised.  The JAX
    package has neither guard: there the iterate turns NaN and the loop
    ends as if converged (ROADMAP queue 3).  A run without a breakdown is
    the JAX package's arithmetic, step for step (a guard on near-breakdowns
    would restart often on saddle-point systems and change the counts)."""
    if M is None:
        M = lambda r: r  # noqa: E731
    x = x_prev = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - A(x)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rhat = r
    rho = alpha = omega = one
    v = p = torch.zeros_like(b)
    tol2 = max(rtol * float(torch.linalg.vector_norm(b)), atol) ** 2
    k = steps = 0  # steps: since the last (re)start
    while k < max_it:
        rho_new = _vdot(rhat, r)
        rr, rho_abs = torch.stack([_vdot(r, r).real, rho_new.abs()]).tolist()  # one host read
        if not (math.isfinite(rr) and math.isfinite(rho_abs)):
            if steps <= 1:
                raise FloatingPointError(
                    f"bicgstab: non-finite residual at iteration {k}, the first step from a finite iterate")
            x, steps = x_prev, 0  # undo the step and restart from the iterate before it
            r = b - A(x)
            rhat, rho, alpha, omega = r, one, one, one
            v = p = torch.zeros_like(b)
            continue
        if not rr > tol2:
            break
        if rho_abs == 0.0:  # breakdown: restart from x
            rhat, rho_new = r, _vdot(r, r)
            rho = alpha = omega = one
            v = p = torch.zeros_like(b)
            steps = 0
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _vdot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = _vdot(t, s) / _vdot(t, t)
        x_prev, x = x, x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
        steps += 1
    return x, k, float(torch.linalg.vector_norm(r))


def _host_dtype(t):
    """numpy scalar type of a tensor's dtype, and of its real part."""
    from .._dtypes import numpy_dtype

    dt = np.dtype(numpy_dtype(t.dtype))
    return dt, np.dtype(dt.type(0).real.dtype)


def gmres(A: Callable, b, M: Callable = None, x0=None, rtol=1e-8, atol=1e-12, max_it=1000, restart=30):
    """Left-preconditioned restarted GMRES(m), m = min(restart, max_it, n),
    with modified Gram-Schmidt and Givens rotations.  The Krylov basis and
    the Gram-Schmidt products stay on b's device; the new Hessenberg column
    is read back once per iteration and rotated on the host in b's dtype.
    Counts iterations over all cycles as the JAX package does (a cycle may
    end past max_it).  Returns (x, iterations, ||b - A x||)."""
    if M is None:
        M = lambda r: r  # noqa: E731
    n = b.shape[0]
    m = int(min(restart, max_it, n))
    dt, rdt = _host_dtype(b)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r0 = M(b - A(x))
    bnorm = rdt.type(float(torch.linalg.vector_norm(M(b))))
    tol = max(rdt.type(rtol) * bnorm, rdt.type(atol))

    def cycle(x):
        """One GMRES(m) cycle from x: (x_new, residual estimate, inner its)."""
        r = M(b - A(x))
        beta_t = torch.linalg.vector_norm(r)
        beta = rdt.type(float(beta_t))
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / beta_t if beta > 0 else r
        H = np.zeros((m + 1, m), dt)
        cs = np.ones(m, dt)
        sn = np.zeros(m, dt)
        g = np.zeros(m + 1, dt)
        g[0] = beta
        j, res = 0, beta
        while j < m and res > tol:
            w = M(A(V[j]))
            hs = []
            for i in range(j + 1):  # modified Gram-Schmidt against rows 0..j
                hi = _vdot(V[i], w)
                w = torch.addcmul(w, hi, V[i], value=-1)  # w - hi V[i] in one launch
                hs.append(hi)
            hj1_t = torch.linalg.vector_norm(w).to(b.dtype)
            V[j + 1] = torch.where(hj1_t.abs() > 0, w / hj1_t, w)
            h = np.zeros(m + 1, dt)
            h[: j + 2] = torch.stack(hs + [hj1_t]).cpu().numpy()
            for i in range(j):  # the earlier rotations on the new column
                hi, hi1 = h[i], h[i + 1]
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -np.conj(sn[i]) * hi + cs[i] * hi1
            hjj, hj1v = h[j], h[j + 1]  # the rotation annihilating h[j+1]
            denom = np.sqrt(np.abs(hjj) ** 2 + np.abs(hj1v) ** 2)
            c_new = dt.type(np.abs(hjj) / denom if denom > 0 else 1.0)
            phase = dt.type(hjj / np.abs(hjj) if np.abs(hjj) > 0 else 1.0)
            s_new = dt.type(phase * np.conj(hj1v) / denom if denom > 0 else 0.0)
            h[j] = c_new * hjj + s_new * hj1v
            h[j + 1] = 0.0
            cs[j], sn[j] = c_new, s_new
            H[:, j] = h
            gj = g[j]
            g[j] = c_new * gj
            g[j + 1] = -np.conj(s_new) * gj
            res = rdt.type(np.abs(g[j + 1]))
            j += 1
        if j:
            from scipy.linalg import solve_triangular

            y = solve_triangular(H[:j, :j], g[:j], lower=False)
            x = x + V[:j].T @ torch.as_tensor(y.astype(dt), device=b.device)
        return x, res, j

    res = rdt.type(float(torch.linalg.vector_norm(r0)))
    it = 0
    while res > tol and it < max_it:
        x, res, j = cycle(x)
        it += j
    return x, it, float(torch.linalg.vector_norm(b - A(x)))


class JacobiPC:
    """Jacobi preconditioner: r -> r / diag (1 where diag == 0), entrywise,
    so diag and r may have any one shape; ``matmat`` applies it to the
    columns of an (n, k) block."""

    def __init__(self, inv):
        self.inv = inv

    def __call__(self, r):
        return self.inv * r

    def matmat(self, R):
        return self.inv[:, None] * R


def jacobi_preconditioner(diag):
    return JacobiPC(torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)))


def default_probe(shape, dtype, device):
    """The Chebyshev power iteration's default start: standard normal
    values from a torch.Generator seeded 0, drawn in float64 on the CPU (the
    same values on every device), then cast."""
    gen = torch.Generator().manual_seed(0)
    return torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype=dtype, device=device)


class ChebyshevPC:
    """Chebyshev iteration of degree `degree` on D^-1 A (the callable DA),
    the interval [lmin_frac, 1] * lmax: the port's one Chebyshev-Jacobi
    recurrence, behind chebyshev_preconditioner, the GMG smoother and
    coarse solve (la/gmg.py) and the sharded Chebyshev
    (parallel/lattice_spmd.py).  Its coefficients are computed once, in
    lmax's type: Python floats for a float lmax, 0-d tensors in the
    operator's dtype for chebyshev_preconditioner's (computed on the
    device, as the JAX package computes them per call)."""

    def __init__(self, DA, inv, lmax, lmin_frac, degree):
        self.DA, self.inv, self.degree = DA, inv, degree
        lmin = lmin_frac * lmax
        self.theta = (lmax + lmin) / 2
        delta = (lmax - lmin) / 2
        sigma = self.theta / delta
        rho = 1.0 / sigma
        self.coef = []
        for _ in range(degree - 1):
            rho_new = 1.0 / (2 * sigma - rho)
            self.coef.append((rho_new * rho, 2 * rho_new / delta))
            rho = rho_new

    def __call__(self, r):
        rr = self.inv * r
        x = rr / self.theta
        if self.degree == 1:
            return x
        res = rr - self.DA(x)
        d = res / self.theta
        for c1, c2 in self.coef:
            d = c1 * d + c2 * res
            x = x + d
            res = res - self.DA(d)
        return x


def chebyshev_preconditioner(A: Callable, diag, lmin_frac=0.06, lmax_safety=1.1, degree=3, n_power=20,
                             probe=None):
    """Chebyshev-Jacobi: a Chebyshev polynomial of degree `degree` on the
    Jacobi-preconditioned operator D^-1 A, lambda_max from `n_power` steps
    of power iteration started at `probe` (a tensor or array of diag's
    shape; default: ``default_probe``, standard normal values from a
    generator seeded 0).  The JAX package draws its default from
    jax.random, which the port cannot reproduce: pass the same probe to
    both to compare them."""
    inv = torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag))

    def DA(x):
        return inv * A(x)

    if probe is None:
        probe = default_probe(diag.shape, diag.dtype, diag.device)
    v = (probe.to(dtype=diag.dtype, device=diag.device) if isinstance(probe, torch.Tensor)
         else torch.tensor(np.asarray(probe), dtype=diag.dtype, device=diag.device))
    for _ in range(n_power):
        v = DA(v)
        v = v / torch.linalg.vector_norm(v)
    lmax = _vdot(v, DA(v)).real * lmax_safety
    return ChebyshevPC(DA, inv, lmax, lmin_frac, degree)


AMG_PC_TYPES = ("gamg", "amg", "hypre", "boomeramg")


def solve(A: Callable, b, options: SolverOptions, diag=None, x0=None, Aop=None, bs=1, Pop=None,
          nullspace=None):
    """Dispatch on SolverOptions; returns (x, its, rnorm).

    Aop: the assembled operator (anything with .to_scipy()), required for
    the AMG pc types; bs is its dof block size.  Pop: an optional separate
    preconditioner operator: the jacobi, chebyshev and AMG preconditioners
    are built from it, while the Krylov method still iterates on A.
    nullspace: optional (n, k) near-nullspace candidates for AMG (the
    rigid-body modes for elasticity)."""
    if Pop is not None:
        pc_src, pc_diag, pc_mv = Pop, Pop.diagonal(), Pop.matvec
    else:
        pc_src, pc_diag, pc_mv = Aop, diag, A
    if options.pc_type in ("jacobi", "chebyshev"):
        if pc_diag is None:
            raise ValueError(f"pc_type={options.pc_type!r} needs the operator diagonal")
        M = (jacobi_preconditioner(pc_diag) if options.pc_type == "jacobi" else
             chebyshev_preconditioner(pc_mv, pc_diag, degree=options.cheb_degree, probe=options.cheb_probe))
    elif options.pc_type == "none":
        M = None
    elif options.pc_type in AMG_PC_TYPES:
        if pc_src is None:
            raise ValueError(f"pc_type={options.pc_type!r} requires the assembled operator (pass Aop=...)")
        from .._dtypes import numpy_dtype
        from .amg import smoothed_aggregation_amg

        M = smoothed_aggregation_amg(pc_src, bs=bs, dtype=numpy_dtype(b.dtype), nullspace=nullspace,
                                     device=b.device)
    else:
        raise ValueError(f"unknown pc_type {options.pc_type!r}")
    kw = dict(M=M, x0=x0, rtol=options.rtol, atol=options.atol, max_it=options.max_it)
    if options.ksp_type == "cg":
        return cg(A, b, **kw)
    if options.ksp_type == "bcgs":
        return bicgstab(A, b, **kw)
    if options.ksp_type == "gmres":
        return gmres(A, b, **kw)
    if options.ksp_type == "preonly":
        raise ValueError("preonly requires an assembled matrix; use a direct solver")
    raise ValueError(f"unknown ksp_type {options.ksp_type}")
