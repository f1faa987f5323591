"""Krylov solvers (torch): preconditioned CG with Jacobi or smoothed-
aggregation AMG.

Counterpart of ``dolfinx_mpc_tpu/la/solvers.py``.  The JAX package's
``lax.while_loop`` becomes a Python loop; the convergence test reads one
scalar back from the device per iteration (capturing the loop in a CUDA
graph is later work).  BiCGStab, GMRES and the Chebyshev preconditioner
come with ROADMAP queue 1, item 18.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

__all__ = ["SolverOptions", "cg", "JacobiPC", "jacobi_preconditioner", "solve"]


@dataclass
class SolverOptions:
    """Mirror of the PETSc options dict surface (ksp_type/pc_type/rtol...)."""

    ksp_type: str = "cg"
    # "none" | "jacobi" | "gamg" (aliases amg/hypre/boomeramg: smoothed
    # aggregation, la/amg.py)
    pc_type: str = "jacobi"
    rtol: float = 1e-8
    atol: float = 1e-12
    max_it: int = 10000

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


class JacobiPC:
    """Jacobi preconditioner: r -> r / diag (1 where diag == 0), entrywise,
    so diag and r may have any one shape."""

    def __init__(self, inv):
        self.inv = inv

    def __call__(self, r):
        return self.inv * r


def jacobi_preconditioner(diag):
    return JacobiPC(torch.where(diag != 0, 1.0 / diag, torch.ones_like(diag)))


AMG_PC_TYPES = ("gamg", "amg", "hypre", "boomeramg")


def solve(A: Callable, b, options: SolverOptions, diag=None, x0=None, Aop=None, bs=1, Pop=None,
          nullspace=None):
    """Dispatch on SolverOptions; returns (x, its, rnorm).

    Aop: the assembled operator (anything with .to_scipy()), required for
    the AMG pc types; bs is its dof block size.  Pop: an optional separate
    preconditioner operator: the jacobi and AMG preconditioners are built
    from it, while CG still iterates on A.  nullspace: optional (n, k)
    near-nullspace candidates for AMG (the rigid-body modes for
    elasticity)."""
    pc_src, pc_diag = (Pop, Pop.diagonal()) if Pop is not None else (Aop, diag)
    if options.pc_type == "jacobi":
        if pc_diag is None:
            raise ValueError("pc_type='jacobi' needs the operator diagonal")
        M = jacobi_preconditioner(pc_diag)
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
        raise NotImplementedError(
            f"pc_type={options.pc_type!r} is not ported yet (ROADMAP queue 1, item 18)")
    if options.ksp_type != "cg":
        raise NotImplementedError(
            f"ksp_type={options.ksp_type!r} is not ported yet (ROADMAP queue 1, item 18)")
    return cg(A, b, M=M, x0=x0, rtol=options.rtol, atol=options.atol, max_it=options.max_it)
