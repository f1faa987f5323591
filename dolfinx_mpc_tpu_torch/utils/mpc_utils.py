"""MPC utilities (numpy host code): the rigid-body near-nullspace.

Copied from ``dolfinx_mpc_tpu/utils/mpc_utils.py:136-160``; the other
helpers of that module wait for ROADMAP queue 1, item 17.
"""

from __future__ import annotations

import numpy as np

from ..fem.functionspace import FunctionSpace

__all__ = ["rigid_motions_nullspace"]


def rigid_motions_nullspace(V: FunctionSpace):
    """Orthonormal rigid-body modes (reference mpc_utils.py:163-215):
    translations + rotations; returned as a (num_dofs, n_modes) array."""
    base = V if V.parent is None else V.parent
    gdim = base.mesh.gdim
    bs = base.block_size
    assert bs == gdim
    num_modes = 3 if gdim == 2 else 6
    N = base.num_dofs
    basis = np.zeros((N, num_modes))
    coords = base.dof_coords_blocks
    for k in range(gdim):
        basis[k :: bs, k][:] = 1.0
    if gdim == 2:
        basis[0::bs, 2] = -coords[:, 1]
        basis[1::bs, 2] = coords[:, 0]
    else:
        basis[0::bs, 3] = -coords[:, 1]
        basis[1::bs, 3] = coords[:, 0]
        basis[0::bs, 4] = coords[:, 2]
        basis[2::bs, 4] = -coords[:, 0]
        basis[2::bs, 5] = coords[:, 1]
        basis[1::bs, 5] = -coords[:, 2]
    q, _ = np.linalg.qr(basis)
    return q
