"""LinearProblem (torch): assemble, solve, backsubstitute.

Counterpart of ``LinearProblem`` in ``dolfinx_mpc_tpu/problem.py``: the
matrix comes from the lattice fast path (lean fold operator; at degree 2
the parity-blocked one, whose flat ``matvec`` the solve uses) on lattice
meshes with a plane-wrap constraint, and from the general slot-CSR
assembler otherwise; the right-hand side from ``assemble_vector`` +
``apply_lifting`` + ``set_bc``, the solve from la/solvers.py (with the
rigid-body near-nullspace attached to AMG on vector spaces), and the slave
values from the constraint's backsubstitution.  The separate
preconditioner form ``P`` and the nonlinear drivers come with ROADMAP
queue 1, item 16.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

from .fem.forms import Form
from .fem.functionspace import Function
from .fem.lattice_info import get_lattice_info
from .la.solvers import AMG_PC_TYPES, SolverOptions, solve as krylov_solve
from .multipointconstraint import MultiPointConstraint
from .ops.assemble import apply_lifting, assemble_matrix, assemble_vector, set_bc
from .ops.lattice import assemble_matrix_lattice

__all__ = ["LinearProblem"]


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
    ):
        if mpc is None or mpc.finalized is None:
            raise RuntimeError("The multi point constraint has to be finalized before calling initializer")
        self._a = a
        self._L = L
        self.mpc = mpc
        self.bcs = bcs or []
        self.u = u if u is not None else Function(a.test_space, dtype=mpc.dtype, device=mpc.device)
        self.options = SolverOptions.from_petsc(petsc_options)
        self._A = None
        self._b = None
        self.its = -1

    def assemble(self):
        dtype = self.mpc.dtype
        self._A = self._assemble_A(dtype)
        b = assemble_vector(self._L, self.mpc, dtype=dtype)
        b = apply_lifting(b, [self._a], [self.bcs], self.mpc, dtype=dtype)
        self._b = set_bc(b, self.bcs)
        return self._A, self._b

    def _assemble_A(self, dtype):
        """The lattice fold operator on structured box meshes with a
        plane-wrap constraint, else the general slot-CSR matrix.  The JAX
        package tries its "cells" lattice format between the two; the port
        has no "cells" format yet (ROADMAP queue 1, item 14) and goes straight
        to the general assembler, which gives the same matrix."""
        a = self._a
        if get_lattice_info(a.test_space.mesh) is None:
            return assemble_matrix(a, self.mpc, self.bcs, dtype=dtype, device=self.mpc.device)
        key = _lattice_key(self.mpc, self.bcs, dtype)
        cache = a.__dict__.setdefault("_compiled_cache", {})
        clf = cache.get(key)
        if clf is None:
            try:
                clf = assemble_matrix_lattice(a, self.mpc, bcs=self.bcs, dtype=dtype,
                                              side_format="fold", device=self.mpc.device)
            except ValueError:  # not a plane wrap: the general assembler
                return assemble_matrix(a, self.mpc, self.bcs, dtype=dtype, device=self.mpc.device)
            cache[key] = clf
        return clf.assemble()

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
        if self.options.pc_type in AMG_PC_TYPES and bs > 1 and bs == V.mesh.gdim:
            from .utils.mpc_utils import rigid_motions_nullspace

            ns = rigid_motions_nullspace(V)
        x, its, rnorm = krylov_solve(A.matvec, b, self.options, diag=A.diagonal(), Aop=A, bs=bs,
                                     nullspace=ns)
        self.its = int(its)
        self.rnorm = float(rnorm)
        x = self.mpc.finalized.backsubstitution(x)
        self.u.x.array.copy_(x)
        return self.u
