"""Solver drivers (torch): LinearProblem (Krylov), NonlinearProblem and
NonlinearProblemNest (Newton).

Counterpart of ``dolfinx_mpc_tpu/problem.py``.  LinearProblem: on lattice
meshes the matrix comes from the lattice fast path, tried as the JAX package
tries it — the fold operator (at scalar degree 2 the parity-blocked one,
whose flat ``matvec`` the solve uses) for a plane-wrap constraint, else the
"cells" side format — wherever the JAX package's SoA element kernel would
take the form; from the general slot-CSR assembler otherwise.  An optional
preconditioner form ``P`` is assembled the same way
and the preconditioner is built from it; the right-hand side from
``assemble_vector`` + ``apply_lifting`` + ``set_bc``, the solve from
la/solvers.py (with the rigid-body near-nullspace attached to AMG on
vector spaces), and the slave values from the constraint's
backsubstitution.  The Newton drivers enforce the constraint on every
iterate (homogenize + backsubstitute before each residual), assemble the
Jacobian from ``derivative`` unless given, and solve each correction with
la/solvers.py; NonlinearProblem has an Armijo backtracking line search,
NonlinearProblemNest (block systems) none, as in the JAX package.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from ._dtypes import numpy_dtype
from .fem.forms import Form, derivative
from .fem.functionspace import Function
from .fem.lattice_info import get_lattice_info
from .la.solvers import AMG_PC_TYPES, SolverOptions, solve as krylov_solve
from .multipointconstraint import MultiPointConstraint
from .ops.assemble import apply_lifting, assemble_matrix, assemble_vector, set_bc
from .ops.lattice import assemble_matrix_lattice
from .utils.timing import timed

__all__ = ["LinearProblem", "NonlinearProblem", "NonlinearProblemNest"]


def _lattice_key(mpc, bcs, dtype):
    """Cache key by VALUE (the JAX package keys on id(), which a collected
    and recycled object can alias): the constraint tables, the bc dofs and
    values, the dtype and the device."""
    h = hashlib.sha256()
    if mpc is not None:
        for arr in (mpc.slaves, mpc._np_masters, mpc._np_coeffs):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(str(mpc.device).encode())
    for bc in bcs:
        h.update(np.ascontiguousarray(bc.dofs).tobytes())
        h.update(np.ascontiguousarray(bc.dof_values(np.float64)).tobytes())
    return ("lattice_clf", h.hexdigest(), np.dtype(dtype).str)


class LinearProblem:
    """Linear constrained problem a(u,v) = L(v) with MPC + Dirichlet BCs."""

    def __init__(
        self,
        a: Form,
        L: Form,
        mpc: MultiPointConstraint,
        bcs=None,
        u: Optional[Function] = None,
        petsc_options: Optional[dict] = None,
        P: Optional[Form] = None,
    ):
        if mpc is None or mpc.finalized is None:
            raise RuntimeError("The multi point constraint has to be finalized before calling initializer")
        self._a = a
        self._L = L
        self.mpc = mpc
        self.bcs = bcs or []
        self.u = u if u is not None else Function(a.test_space, dtype=mpc.dtype, device=mpc.device)
        self.options = SolverOptions.from_petsc(petsc_options)
        self._P = P
        self._P_mat = None
        self._A = None
        self._b = None
        self.its = -1

    def assemble(self):
        dtype = self.mpc.dtype
        self._A = self._assemble_A(dtype)
        # the separate preconditioner operator, assembled with the same
        # constraint and bcs as A: solve() builds the pc from it while the
        # Krylov method still iterates on A
        if self._P is not None:
            self._P_mat = self._assemble_A(dtype, form=self._P)
        b = assemble_vector(self._L, self.mpc, dtype=dtype)
        b = apply_lifting(b, [self._a], [self.bcs], self.mpc, dtype=dtype)
        self._b = set_bc(b, self.bcs)
        return self._A, self._b

    def _assemble_A(self, dtype, form=None):
        """On a lattice mesh the fold operator, else the "cells" side
        format, else — and whenever the form is one the JAX package's SoA
        element kernel would not take (soa_supported), where the JAX
        package falls back too — the general slot-CSR matrix
        (dolfinx_mpc_tpu/problem.py:71-98).  Each lattice form compiles
        once per value-keyed constraint, bcs and dtype, complex dtypes
        included."""
        a = self._a if form is None else form
        general = lambda: assemble_matrix(a, self.mpc, self.bcs, dtype=dtype, device=self.mpc.device)  # noqa: E731
        if get_lattice_info(a.test_space.mesh) is None:
            return general()
        key = _lattice_key(self.mpc, self.bcs, dtype)
        cache = a.__dict__.setdefault("_compiled_cache", {})
        if key not in cache:
            clf = None
            for fmt in ("fold", "cells"):
                try:
                    clf = assemble_matrix_lattice(a, self.mpc, bcs=self.bcs, dtype=dtype, side_format=fmt,
                                                  device=self.mpc.device)
                    break
                except ValueError:  # not a plane wrap / no SoA kernel
                    clf = None
            cache[key] = clf if clf is not None and clf.soa else None
        clf = cache[key]
        return general() if clf is None else clf.assemble()

    @property
    def A(self):
        return self._A

    @property
    def b(self):
        return self._b

    def solve(self) -> Function:
        A, b = self.assemble()
        # AMG on a vector space: attach the rigid-body near-nullspace (what
        # the reference does by hand with GAMG)
        ns = None
        V = self.u.function_space
        bs = getattr(V, "block_size", 1)
        if (self.options.pc_type in AMG_PC_TYPES and not getattr(V, "is_mixed", False)
                and bs > 1 and bs == V.mesh.gdim):
            from .utils.mpc_utils import rigid_motions_nullspace

            ns = rigid_motions_nullspace(V)
        with timed("~MPC: Solve linear problem"):
            x, its, rnorm = krylov_solve(A.matvec, b, self.options, diag=A.diagonal(), Aop=A, bs=bs,
                                         Pop=self._P_mat, nullspace=ns)
        self.its = int(its)
        self.rnorm = float(rnorm)
        with timed("~MPC: Backsubstitution"):
            x = self.mpc.finalized.backsubstitution(x)
        self.u.x.array.copy_(x)
        return self.u


def _check_finalized(mpcs):
    for mpc in mpcs:
        if mpc is not None and mpc.finalized is None:
            raise RuntimeError("The multi point constraint has to be finalized before calling initializer")


class NonlinearProblem:
    """Newton solve of F(u; v) = 0 with the constraint enforced on every
    iterate (homogenize + backsubstitute before each residual).  J defaults
    to derivative(F, u_name).  line_search "bt": backtracking Armijo on
    ||F|| with up to max_backtracks halvings (the best trial is taken if
    none decreases enough); "none": full Newton steps.  Assembly follows
    the constraint's dtype and device (without one: u's)."""

    def __init__(self, F: Form, u: Function, mpc: MultiPointConstraint, bcs=None, J: Optional[Form] = None,
                 petsc_options: Optional[dict] = None, u_name: str = "u", rtol: float = 1e-10,
                 atol: float = 1e-10, max_it: int = 50, line_search: str = "bt", max_backtracks: int = 8):
        _check_finalized([mpc])
        self._F = F
        self._J = J if J is not None else derivative(F, u_name)
        self.u = u
        self.u_name = u_name
        self.mpc = mpc
        self.bcs = bcs or []
        self.options = SolverOptions.from_petsc(petsc_options)
        self.rtol, self.atol, self.max_it = rtol, atol, max_it
        if line_search not in ("bt", "none"):
            raise ValueError(f"unknown line_search {line_search!r}")
        self.line_search = line_search
        self.max_backtracks = max_backtracks

    def _kw(self):
        mpc = self.mpc
        dtype = mpc.dtype if mpc is not None else numpy_dtype(self.u.x.array.dtype)
        device = mpc.device if mpc is not None else self.u.x.array.device
        return dict(dtype=dtype, device=device)

    def _residual(self):
        """Enforce the constraint on the current iterate, then assemble the
        negated, lifted, bc-set residual.  Returns (rhs, ||rhs||)."""
        mpc, u, kw = self.mpc, self.u, self._kw()
        if mpc is not None:
            mpc.homogenize(u)
            mpc.backsubstitution(u)
        rhs = -assemble_vector(self._F, mpc, **kw)
        # a snapshot, not a view: the line search writes u.x.array in place
        uarr = u.x.array.clone()
        rhs = apply_lifting(rhs, [self._J], [self.bcs], mpc, x0=uarr, scale=1.0, **kw)
        rhs = set_bc(rhs, self.bcs, x0=uarr, scale=1.0)
        return rhs, float(torch.linalg.vector_norm(rhs))

    def solve(self):
        """Returns (num_newton_iterations, converged)."""
        mpc, u, kw = self.mpc, self.u, self._kw()
        arr = u.x.array
        converged = False
        it = 0
        rhs, rnorm = self._residual()
        r0 = max(rnorm, 1e-30)
        for it in range(1, self.max_it + 1):
            if rnorm < self.atol or rnorm / r0 < self.rtol:
                converged = True
                break
            A = assemble_matrix(self._J, mpc, self.bcs, **kw)
            du, _, _ = krylov_solve(A.matvec, rhs, self.options, diag=A.diagonal(), Aop=A,
                                    bs=getattr(u.function_space, "block_size", 1))
            if mpc is not None:
                du = mpc.finalized.backsubstitution(du)
            # a snapshot, not a view: the trials below write u.x.array in
            # place, and an aliased start would compound them
            uarr = arr.clone()
            if self.line_search == "none":
                arr.copy_(uarr + du)
                rhs, rnorm = self._residual()
                continue
            alpha, accepted = 1.0, False
            best_alpha, best_rn = 1.0, np.inf
            rhs_t, rn_t = rhs, rnorm
            for _ in range(self.max_backtracks + 1):
                arr.copy_(uarr + alpha * du)
                rhs_t, rn_t = self._residual()
                if rn_t < best_rn:
                    best_alpha, best_rn = alpha, rn_t
                if rn_t <= (1.0 - 1e-4 * alpha) * rnorm:
                    accepted = True
                    break
                alpha *= 0.5
            if not accepted and best_alpha != alpha:
                arr.copy_(uarr + best_alpha * du)
                rhs_t, rn_t = self._residual()
            rhs, rnorm = rhs_t, rn_t
        if mpc is not None:
            mpc.backsubstitution(u)
        return it, converged


class NonlinearProblemNest:
    """Newton solve of a block residual system F_i(u_0..u_{n-1}; v_i) = 0
    with a per-block constraint enforced on every iterate (the reference's
    SNES-on-MATNEST path, demo_stokes_nonlinear_nest).

    F: list of rank-1 Forms (row residuals); their coefficient dicts name
       the unknowns by `u_names`.
    u: list of Functions (the unknowns, updated in place).
    mpcs: one finalized MultiPointConstraint per block.
    J: optional 2D list of bilinear Forms; J[i][j] defaults to
       derivative(F[i], u_names[j]) when F_i depends on u_j.
    ksp_type defaults to gmres; no line search, as in the JAX package.
    """

    def __init__(self, F, u, mpcs, bcs=None, J=None, petsc_options=None, u_names=None, rtol=1e-10, atol=1e-10,
                 max_it=50):
        n = len(F)
        assert len(u) == n and len(mpcs) == n
        _check_finalized(mpcs)
        self._F = list(F)
        self.u = list(u)
        self.mpcs = list(mpcs)
        self.bcs = bcs or []
        self.u_names = list(u_names) if u_names is not None else [f"u{i}" for i in range(n)]
        if J is None:
            J = [[None] * n for _ in range(n)]
            for i in range(n):
                for j in range(n):
                    if any(self.u_names[j] in t.coefficients for t in F[i].terms):
                        J[i][j] = derivative(F[i], self.u_names[j])
        self._J = J
        opts = dict(petsc_options or {})
        opts.setdefault("ksp_type", "gmres")
        self.options = SolverOptions.from_petsc(opts)
        self.rtol, self.atol, self.max_it = rtol, atol, max_it

    def _bcs_for(self, V):
        from .ops.assemble import _bc_applies

        return [bc for bc in self.bcs if _bc_applies(bc, V)]

    def solve(self):
        """Returns (num_newton_iterations, converged)."""
        from .ops.nest import assemble_matrix_nest, create_matrix_nest

        n = len(self._F)
        spaces = [ui.function_space for ui in self.u]
        sizes = [V.num_dofs for V in spaces]
        dtype = next((m.dtype for m in self.mpcs if m is not None), np.float64)
        converged = False
        r0 = None
        it = 0
        for it in range(1, self.max_it + 1):
            for mpc, ui in zip(self.mpcs, self.u):
                if mpc is not None and mpc.num_local_slaves:
                    mpc.homogenize(ui)
                    mpc.backsubstitution(ui)
            rhs_parts = []
            for i in range(n):
                rhs = -assemble_vector(self._F[i], self.mpcs[i], dtype=dtype)
                for j in range(n):
                    Jij = self._J[i][j]
                    bcs_j = self._bcs_for(spaces[j]) if Jij is not None else []
                    if bcs_j:
                        rhs = apply_lifting(rhs, [Jij], [bcs_j], self.mpcs[i], x0=self.u[j].x.array.clone(),
                                            scale=1.0, dtype=dtype)
                bcs_i = self._bcs_for(spaces[i])
                if bcs_i:
                    rhs = set_bc(rhs, bcs_i, x0=self.u[i].x.array.clone(), scale=1.0)
                rhs_parts.append(rhs)
            rhs_all = torch.cat(rhs_parts)
            rnorm = float(torch.linalg.vector_norm(rhs_all))
            if r0 is None:
                r0 = max(rnorm, 1e-30)
            if rnorm < self.atol or rnorm / r0 < self.rtol:
                converged = True
                break
            A = create_matrix_nest(self._J, self.mpcs)
            assemble_matrix_nest(A, self._J, self.mpcs, bcs=self.bcs)
            # Aop enables the AMG pc types on the Newton inner solve
            du, _, _ = krylov_solve(A.matvec, rhs_all, self.options, diag=A.diagonal(), Aop=A)
            off = 0
            for i in range(n):
                dui = du[off: off + sizes[i]]
                off += sizes[i]
                mpc = self.mpcs[i]
                if mpc is not None and mpc.num_local_slaves:
                    dui = mpc.finalized.backsubstitution(dui)
                arr = self.u[i].x.array
                arr.copy_(arr + dui.to(arr.dtype))
        for mpc, ui in zip(self.mpcs, self.u):
            if mpc is not None and mpc.num_local_slaves:
                mpc.backsubstitution(ui)
        return it, converged
