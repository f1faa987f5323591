"""Matrix-free K^H A K operator (torch).

Counterpart of ``dolfinx_mpc_tpu/ops/matfree.py``: the reduced operator

    y = K^H (A (K x))  + diagval * (slave/bc identity)

without an assembled matrix.  A's action is element-local: gather x per
cell, a batched per-cell product ``A_e @ x_e``, ``index_add_`` back.  The
element tensors A_e are tabulated once at construction; ``refresh()``
tabulates them again after the coefficients change.  Memory O(n_cells nd^2)
instead of O(nnz) CSR, and no sparsity pattern at all.  The JAX package has
no Pallas kernel here (an XLA batched dot), and neither has the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .._dtypes import torch_dtype
from ..fem.forms import Form
from ..multipointconstraint import MultiPointConstraint
from .assemble import _bc_masks, _mpc_pair, _real_dtype, _resolve
from .kernels import compile_term

__all__ = ["MatrixFreeKTAK"]


class MatrixFreeKTAK:
    """Linear operator for the reduced system K^H A K with Dirichlet rows
    replaced by diagval·I (the system LinearProblem assembles explicitly).
    dtype and device default to the constraint's (float64 on the card
    without one)."""

    def __init__(self, a: Form, mpc: Optional[MultiPointConstraint] = None, bcs=None, diagval=1.0, dtype=None,
                 device=None):
        bcs = bcs or []
        mpc_r, _ = _mpc_pair(mpc)
        dtype, device = _resolve(mpc, dtype, device)
        V = a.test_space
        assert a.trial_space is V, "matrix-free path needs square forms"
        self.V = V
        self.mpc = mpc_r
        self.dtype = dtype
        self.device = device
        self.diagval = diagval
        self._terms = [compile_term(t, V, V) for t in a.terms]
        mesh = V.mesh
        as_i = lambda arr: torch.as_tensor(np.asarray(arr, np.int64), device=device)  # noqa: E731
        self._tabs = [dict(coords=torch.as_tensor(mesh.points[mesh.cells[ct.cells]],
                                                  dtype=torch_dtype(_real_dtype(dtype)), device=device),
                           lf=as_i(ct.local_facets), dm=as_i(V.dofmap[ct.cells]),
                           wdofmaps={n: as_i(W.dofmap[ct.cells]) for n, W in zip(ct.coeff_names, ct.coeff_spaces)})
                      for ct in self._terms]
        rdt = torch_dtype(_real_dtype(dtype))
        self._bc_mask = torch.as_tensor(_bc_masks(V, bcs, dtype), device=device)
        if mpc_r is not None and mpc_r.num_local_slaves:
            self._slave_mask = torch.as_tensor(mpc_r.is_slave, dtype=rdt, device=device)
        else:
            self._slave_mask = torch.zeros(V.num_dofs, dtype=rdt, device=device)
        self.refresh()

    def refresh(self):
        """(Re-)tabulate the element tensors (coefficients may have changed)."""
        tdt = torch_dtype(self.dtype)
        self._Ae = []
        for ct, tb in zip(self._terms, self._tabs):
            wl = {n: ct.term.coefficients[n].x.array.to(self.device)[tb["wdofmaps"][n]] for n in ct.coeff_names}
            self._Ae.append(ct.kernel(tb["coords"], tb["lf"], wl).to(tdt))

    @property
    def shape(self):
        return (self.V.num_dofs, self.V.num_dofs)

    def matvec(self, x):
        N = self.V.num_dofs
        fmpc = self.mpc.finalized if self.mpc is not None else None
        bc, sl = self._bc_mask, self._slave_mask
        keep = ((1.0 - bc) * (1.0 - sl)).to(x.dtype)
        # u = K x (on non-bc dofs)
        u = x * keep
        if fmpc is not None:
            u = fmpc.backsubstitution(u)
        y = torch.zeros(N, dtype=x.dtype, device=x.device)
        for Ae, tb in zip(self._Ae, self._tabs):
            ye = torch.bmm(Ae.to(x.dtype), u[tb["dm"]].unsqueeze(2)).squeeze(2)
            y.index_add_(0, tb["dm"].reshape(-1), ye.reshape(-1))
        # z = K^H y, zero slave rows; bc/slave rows: diagval * x
        if fmpc is not None:
            y = fmpc.reduce_transpose(y)
        return y * keep + (bc + sl).to(x.dtype) * self.diagval * x

    def diagonal(self):
        """Jacobi diagonal of K^H A K from the element tensors: diag[i] = sum
        over cells of (Ae)_ii on non-slave, non-bc dofs, diagval on the rest.
        Master-master couplings from the elimination are not included
        (Jacobi quality only; exact values come from the assembled path)."""
        N = self.V.num_dofs
        diag = torch.zeros(N, dtype=torch_dtype(self.dtype), device=self.device)
        for Ae, tb in zip(self._Ae, self._tabs):
            diag.index_add_(0, tb["dm"].reshape(-1), torch.diagonal(Ae, dim1=1, dim2=2).reshape(-1))
        keep = (1.0 - self._bc_mask) * (1.0 - self._slave_mask)
        return diag * keep.to(diag.dtype) + (self._bc_mask + self._slave_mask).to(diag.dtype) * self.diagval
