"""Build the port's objects from state given as numpy arrays.

A test takes a JAX-package operator or constraint, calls ``np.asarray`` on
its arrays, and hands them to these constructors, so that both packages act
on exactly the same data.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from ..multipointconstraint import FinalizedMPC
from ..ops.lattice import BlockDIAMatrix, DIAMatrix, LatticeOperator

__all__ = ["dia_from_numpy", "block_dia_from_numpy", "fold_operator_from_numpy",
           "finalized_mpc_from_numpy"]


def dia_from_numpy(data, offsets, vshape, bs, device="cpu") -> DIAMatrix:
    """DIAMatrix from data (n_off, bs, bs, n0, n1, n2) and host offsets."""
    t = torch.as_tensor(np.array(data), device=device)
    return DIAMatrix(t, offsets, vshape, bs)


def block_dia_from_numpy(data, trips, vshape, r3, device="cpu") -> BlockDIAMatrix:
    """BlockDIAMatrix from data (n_trip, s0, s1, s2) and host triples."""
    t = torch.as_tensor(np.array(data), device=device)
    return BlockDIAMatrix(t, trips, vshape, r3)


def fold_operator_from_numpy(dia, fold_axis, fold_mask, diagval, device="cpu", fold_pairs=None,
                             fold_mask_b=None) -> LatticeOperator:
    """Fold LatticeOperator over `dia` (a DIAMatrix or BlockDIAMatrix
    already on `device`); fold_mask_b is the blocked fold mask of a
    BlockDIAMatrix."""
    m = torch.as_tensor(np.array(fold_mask, bool), device=device)
    mb = None if fold_mask_b is None else torch.as_tensor(np.array(fold_mask_b, bool), device=device)
    return LatticeOperator(dia, float(np.real(np.asarray(diagval))), int(fold_axis), m, fold_pairs,
                           fold_mask_b=mb)


def finalized_mpc_from_numpy(slaves, masters, coeffs, is_slave, num_dofs, device="cpu") -> FinalizedMPC:
    """FinalizedMPC from its four host tables."""
    dev = torch.device(device)
    return FinalizedMPC(
        torch.as_tensor(np.array(slaves, np.int64), device=dev),
        torch.as_tensor(np.array(masters, np.int64), device=dev),
        torch.as_tensor(np.array(coeffs), device=dev),
        torch.as_tensor(np.array(is_slave, bool), device=dev),
        int(num_dofs),
    )
