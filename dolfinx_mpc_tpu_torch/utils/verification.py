"""Algebraic verification oracle: explicit K, K^H A K / K^H b (scipy).

Counterpart of ``dolfinx_mpc_tpu/utils/verification.py`` (host numpy/scipy,
copied).  The oracle's unconstrained matrix comes either from the port's
general assembler, ``assemble_matrix(a, None, bcs).to_scipy()`` (as the JAX
package takes it), or from ``assemble_matrix_scipy``, which sums the port's
element matrices on the host with scipy and shares no assembly code with
the device paths.  The oracle is then u = K (K^T A K)^{-1} K^T b.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

__all__ = ["assemble_matrix_scipy", "gather_transformation_matrix"]


def gather_transformation_matrix(mpc, root=0) -> sp.csr_matrix:
    """Explicit K: (num_dofs, num_reduced) with identity rows for non-slave
    dofs and coefficient rows for slaves."""
    N = mpc.V.num_dofs
    slaves = np.asarray(mpc.slaves, dtype=np.int64)
    is_slave = np.zeros(N, dtype=bool)
    is_slave[slaves] = True
    reduced = np.flatnonzero(~is_slave)
    red_index = -np.ones(N, dtype=np.int64)
    red_index[reduced] = np.arange(len(reduced))
    rows, cols, vals = [], [], []
    rows.extend(reduced.tolist())
    cols.extend(red_index[reduced].tolist())
    vals.extend([1.0] * len(reduced))
    flat_m, offs = mpc.masters
    flat_c, _ = mpc.coefficients
    for i, s in enumerate(slaves):
        for m, c in zip(flat_m[offs[i] : offs[i + 1]], flat_c[offs[i] : offs[i + 1]]):
            if red_index[m] < 0:
                raise ValueError("master is a slave")
            rows.append(int(s))
            cols.append(int(red_index[m]))
            vals.append(c)
    dtype = np.asarray(flat_c).dtype if len(flat_c) else np.float64
    return sp.csr_matrix((np.asarray(vals, dtype), (rows, cols)), shape=(N, len(reduced)))


def assemble_matrix_scipy(form, bcs=None, diagval=1.0) -> sp.csr_matrix:
    """Unconstrained host matrix of a square bilinear form in float64: cell
    element matrices from the port's element kernel on the CPU, summed into
    CSR, bc rows and columns zeroed with diagval on their diagonal."""
    from ..ops.kernels import compile_term

    V = form.test_space
    N = V.num_dofs
    A = sp.csr_matrix((N, N))
    mesh = V.mesh
    for term in form.terms:
        ct = compile_term(term, V, form.trial_space)
        coords = torch.as_tensor(mesh.points[mesh.cells[ct.cells]], dtype=torch.float64)
        wl = {n: f.x.array.cpu().to(torch.float64)[torch.as_tensor(W.dofmap[ct.cells])]
              for (n, f), W in zip(term.coefficients.items(), ct.coeff_spaces)}
        Ae = ct.kernel(coords, wl).numpy()  # (n_cells, nd, nd)
        dm = V.dofmap[ct.cells]
        nd = dm.shape[1]
        A = A + sp.csr_matrix((Ae.reshape(-1), (np.repeat(dm, nd, axis=1).reshape(-1),
                                                np.tile(dm, (1, nd)).reshape(-1))), shape=(N, N))
    if bcs:
        bc = np.unique(np.concatenate([b.dofs for b in bcs]))
        keep = np.ones(N)
        keep[bc] = 0.0
        D = sp.diags(keep)
        A = D @ A @ D + sp.diags(np.where(keep == 0.0, diagval, 0.0))
    return A.tocsr()
