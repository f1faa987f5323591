"""One constrained forward step on one device.

Counterpart of the JAX package's ``entry()`` (``__graft_entry__.py``), the
single-device sibling of the dry run (parallel/dryrun.py): the periodic
Poisson problem of ``parallel.dryrun.build_problem(n)`` and a step that
assembles the K^H A K values from the compiled tables, runs a fixed block
of CG iterations on them and backsubstitutes.

    from dolfinx_mpc_tpu_torch import entry
    step, (b,) = entry(device="cpu")
    u = step(b)
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["entry"]

# the JAX step's fixed CG block: every step runs exactly this many iterations
CG_ITERATIONS = 50


def entry(n=8, device=None):
    """(step, (b,)): ``step(b)`` is one constrained forward step on the
    periodic Poisson problem at n (P1 on the unit square, periodic in x,
    Dirichlet 0 on y = 0 and 1), in float64 on `device` (the card unless the
    caller asks for the CPU):

    1. the slot-CSR values of K^H A K from the compiled tables, with the
       Dirichlet row and column masks, 1 on the slave and Dirichlet
       diagonals;
    2. exactly CG_ITERATIONS unpreconditioned CG iterations from zero with
       the CSR matvec (gather, multiply, ``index_add_`` over the row ids),
       with no early exit;
    3. backsubstitution u = K x.

    b is ``assemble_vector(L, mpc)`` on the device; every table is built
    once here and closed over.  The step is plain torch, as the JAX step is
    plain XLA: no kernel of csrc/ runs in it."""
    from .la.sparse import CSRMatrix
    from .ops.assemble import _bc_masks, _get_compiled_matrix, _matrix_values, assemble_vector
    from .parallel.dryrun import build_problem

    V, a, L, mpc, bc = build_problem(n, device=device)
    dev = mpc.device
    dtype = np.dtype(np.float64)
    cm = _get_compiled_matrix(a, mpc, dtype, dev)
    bc_mask = torch.as_tensor(_bc_masks(V, [bc], dtype), device=dev)
    bc_diag = torch.zeros(V.num_dofs, dtype=torch.float64, device=dev)
    bc_diag[torch.as_tensor(bc.dofs, device=dev)] = 1.0
    indices, indptr, row_ids = (torch.as_tensor(np.asarray(ix, np.int64), device=dev)
                                for ix in (cm.pattern.indices, cm.pattern.indptr, cm.pattern.row_ids))
    fmpc = mpc.finalized

    def step(b):
        data = _matrix_values(cm, bc_mask, bc_mask, bc_diag, 1.0, torch.float64)
        matvec = CSRMatrix(data, indices, indptr, row_ids, cm.pattern.shape).matvec
        x = torch.zeros_like(b)
        r = b - matvec(x)
        p = r
        rz = torch.vdot(r, r)
        for _ in range(CG_ITERATIONS):
            Ap = matvec(p)
            alpha = rz / torch.vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            rz_new = torch.vdot(r, r)
            p = r + (rz_new / rz) * p
            rz = rz_new
        return fmpc.backsubstitution(x)

    b = assemble_vector(L, mpc)
    return step, (b,)
