"""Build the port's objects from state given as numpy arrays.

A test takes a JAX-package operator or constraint, calls ``np.asarray`` on
its arrays, and hands them to these constructors, so that both packages act
on exactly the same data.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..la.bell import BellMatrix, bell_from_arrays
from ..la.ell import BlockEllMatrix, ell_from_arrays
from ..la.sparse import CSRMatrix, csr_from_scipy
from ..multipointconstraint import FinalizedMPC
from ..ops.lattice import BlockDIAMatrix, DIAMatrix, LatticeOperator

__all__ = ["dia_from_numpy", "block_dia_from_numpy", "fold_operator_from_numpy",
           "finalized_mpc_from_numpy", "csr_from_numpy", "ell_from_numpy", "bell_from_numpy"]


def dia_from_numpy(data, offsets, vshape, bs, device=DEFAULT_DEVICE) -> DIAMatrix:
    """DIAMatrix from data (n_off, bs, bs, n0, n1, n2) and host offsets."""
    t = torch.as_tensor(np.array(data), device=resolve_device(device))
    return DIAMatrix(t, offsets, vshape, bs)


def block_dia_from_numpy(data, trips, vshape, r3, device=DEFAULT_DEVICE) -> BlockDIAMatrix:
    """BlockDIAMatrix from data (n_trip, s0, s1, s2) and host triples."""
    t = torch.as_tensor(np.array(data), device=resolve_device(device))
    return BlockDIAMatrix(t, trips, vshape, r3)


def fold_operator_from_numpy(dia, fold_axis, fold_mask, diagval, device=DEFAULT_DEVICE, fold_pairs=None,
                             fold_mask_b=None) -> LatticeOperator:
    """Fold LatticeOperator over `dia` (a DIAMatrix or BlockDIAMatrix
    already on `device`); fold_mask_b is the blocked fold mask of a
    BlockDIAMatrix."""
    device = resolve_device(device)
    m = torch.as_tensor(np.array(fold_mask, bool), device=device)
    mb = None if fold_mask_b is None else torch.as_tensor(np.array(fold_mask_b, bool), device=device)
    return LatticeOperator(dia, float(np.real(np.asarray(diagval))), int(fold_axis), m, fold_pairs,
                           fold_mask_b=mb)


def finalized_mpc_from_numpy(slaves, masters, coeffs, is_slave, num_dofs, device=DEFAULT_DEVICE) -> FinalizedMPC:
    """FinalizedMPC from its four host tables."""
    dev = resolve_device(device)
    return FinalizedMPC(
        torch.as_tensor(np.array(slaves, np.int64), device=dev),
        torch.as_tensor(np.array(masters, np.int64), device=dev),
        torch.as_tensor(np.array(coeffs), device=dev),
        torch.as_tensor(np.array(is_slave, bool), device=dev),
        int(num_dofs),
    )


def csr_from_numpy(data, indices, indptr, shape, device=DEFAULT_DEVICE) -> CSRMatrix:
    """CSRMatrix from the CSR arrays of a JAX-package CSRMatrix."""
    import scipy.sparse as sp

    return csr_from_scipy(sp.csr_matrix((np.array(data), np.array(indices), np.array(indptr)), shape=tuple(shape)),
                          device=device)


def ell_from_numpy(data, cols, diag, rem_data, rem_rows, rem_cols, shape, device=DEFAULT_DEVICE) -> BlockEllMatrix:
    """BlockEllMatrix from the arrays of a JAX-package BlockEllMatrix."""
    return ell_from_arrays(*(np.array(a) for a in (data, cols, diag, rem_data, rem_rows, rem_cols)),
                           tuple(shape), device=device)


def bell_from_numpy(data, cols, diag, rem_data, rem_rows, rem_cols, shape, device=DEFAULT_DEVICE) -> BellMatrix:
    """BellMatrix from the arrays of a JAX-package BellMatrix."""
    return bell_from_arrays(*(np.array(a) for a in (data, cols, diag, rem_data, rem_rows, rem_cols)),
                            tuple(shape), device=device)
