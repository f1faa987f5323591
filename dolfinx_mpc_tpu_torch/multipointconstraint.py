"""MultiPointConstraint: the MPC container as padded gather tables (torch).

Counterpart of ``dolfinx_mpc_tpu/multipointconstraint.py``.  A finalized
constraint is four tensors on an explicit device — slaves, a padded
(n_slaves, max_masters) master-index table, matching coefficients and an
is_slave marker — so backsubstitution (u[s] = sum c·u[m]) is one gather-FMA.
The builder lifecycle (add constraints, finalize) and its host-side numpy
tables are the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ._device import DEFAULT_DEVICE, resolve_device
from ._dtypes import torch_dtype
from .fem.functionspace import Function, FunctionSpace
from .utils.timing import timed

__all__ = ["MPCData", "FinalizedMPC", "MultiPointConstraint"]


@dataclass
class MPCData:
    """Flat constraint POD: slaves are unrolled dof indices, masters/coeffs
    in CSR layout via offsets."""

    slaves: np.ndarray
    masters: np.ndarray
    coeffs: np.ndarray
    owners: np.ndarray
    offsets: np.ndarray


class FinalizedMPC:
    """Device-resident constraint tables.

    slaves: (n_s,) int64 unrolled dof indices
    masters: (n_s, MM) int64 padded master dof indices (0-padded)
    coeffs: (n_s, MM) padded coefficients (0-padded => padding is inert)
    is_slave: (num_dofs,) bool
    """

    def __init__(self, slaves, masters, coeffs, is_slave, num_dofs):
        self.slaves = slaves
        self.masters = masters
        self.coeffs = coeffs
        self.is_slave = is_slave
        self.num_dofs = num_dofs

    @property
    def n_slaves(self):
        return self.slaves.shape[0]

    def backsubstitution(self, u):
        """u[s] = sum_j c_j u[m_j]; returns a new tensor."""
        if self.n_slaves == 0:
            return u
        vals = (self.coeffs * u[self.masters].to(self.coeffs.dtype)).sum(dim=1)
        out = u.clone()
        out[self.slaves] = vals.to(u.dtype)
        return out

    def homogenize(self, u):
        """u[s] = 0; returns a new tensor."""
        if self.n_slaves == 0:
            return u
        out = u.clone()
        out[self.slaves] = 0
        return out

    def expand(self, u_reduced):
        """Alias of backsubstitution: û -> u = K û, a new tensor."""
        return self.backsubstitution(u_reduced)

    def reduce_transpose(self, y):
        """y_red = K^H y: add conj(c)*y[slave] into masters, zero slaves."""
        if self.n_slaves == 0:
            return y
        contrib = (torch.conj(self.coeffs) * y[self.slaves][:, None]).reshape(-1)
        out = y.clone().index_add_(0, self.masters.reshape(-1), contrib.to(y.dtype))
        out[self.slaves] = 0
        return out


class MultiPointConstraint:
    """Builder with the reference's add/finalize lifecycle.  ``dtype`` is the
    scalar type of the coefficients and of everything assembled against this
    constraint; ``device`` is where the finalized tables (and those
    assemblies) live."""

    def __init__(self, V: FunctionSpace, dtype=np.float64, device=DEFAULT_DEVICE):
        self.V = V
        self.dtype = np.dtype(dtype)
        self.device = resolve_device(device)
        self._slaves = []
        self._masters = []
        self._coeffs = []
        self.finalized: Optional[FinalizedMPC] = None

    # -- accumulation --------------------------------------------------
    def add_constraint(self, V, slaves, masters, coeffs, owners=None, offsets=None):
        """Append constraints: slaves/masters are unrolled dof indices;
        offsets is the CSR offset array (len(slaves)+1)."""
        if self.finalized is not None:
            raise RuntimeError("already finalized")
        slaves = np.asarray(slaves, dtype=np.int64)
        masters = np.asarray(masters, dtype=np.int64)
        coeffs = np.asarray(coeffs, dtype=self.dtype)
        if offsets is None:
            offsets = np.arange(len(slaves) + 1, dtype=np.int64)
        offsets = np.asarray(offsets, dtype=np.int64)
        if len(offsets) != len(slaves) + 1:
            raise ValueError("offsets must have len(slaves) + 1 entries")
        for i, s in enumerate(slaves):
            self._slaves.append(int(s))
            self._masters.append(masters[offsets[i] : offsets[i + 1]])
            self._coeffs.append(coeffs[offsets[i] : offsets[i + 1]])

    def add_constraint_from_mpc_data(self, V, mpc_data: MPCData):
        self.add_constraint(V, mpc_data.slaves, mpc_data.masters, mpc_data.coeffs,
                            mpc_data.owners, mpc_data.offsets)

    # -- constraint generators (mirror the reference API) ---------------
    def create_general_constraint(self, slave_master_dict, subspace_slave=None, subspace_master=None):
        from .constraints import create_dictionary_constraint

        data = create_dictionary_constraint(self.V, slave_master_dict, subspace_slave, subspace_master, self.dtype)
        self.add_constraint_from_mpc_data(self.V, data)

    def create_periodic_constraint_topological(self, V, meshtag, tag, relation, bcs=None, scale=1.0):
        from .constraints import create_periodic_condition_topological

        data = create_periodic_condition_topological(V, meshtag, tag, relation, bcs or [], scale, self.dtype)
        self.add_constraint_from_mpc_data(V, data)

    def create_periodic_constraint_geometrical(self, V, indicator, relation, bcs=None, scale=1.0):
        from .constraints import create_periodic_condition_geometrical

        data = create_periodic_condition_geometrical(V, indicator, relation, bcs or [], scale, self.dtype)
        self.add_constraint_from_mpc_data(V, data)

    def create_slip_constraint(self, space, facet_marker, v, bcs=None):
        from .constraints import create_slip_condition

        data = create_slip_condition(space, facet_marker, v, bcs or [], self.dtype)
        self.add_constraint_from_mpc_data(space, data)

    def create_contact_slip_condition(self, meshtags, slave_marker, master_marker, normal, eps2=1e-20):
        from .constraints import create_contact_slip_condition

        data = create_contact_slip_condition(self.V, meshtags, slave_marker, master_marker, normal, eps2,
                                             self.dtype)
        self.add_constraint_from_mpc_data(self.V, data)

    def create_contact_inelastic_condition(self, meshtags, slave_marker, master_marker, eps2=1e-20,
                                           allow_missing_masters=False):
        from .constraints import create_contact_inelastic_condition

        data = create_contact_inelastic_condition(
            self.V, meshtags, slave_marker, master_marker, eps2, allow_missing_masters, self.dtype)
        self.add_constraint_from_mpc_data(self.V, data)

    # -- finalize -------------------------------------------------------
    def finalize(self) -> None:
        """Freeze into padded tables on ``self.device`` (span "~MPC: Finalize MPC")."""
        with timed("~MPC: Finalize MPC"):
            if self.finalized is not None:
                raise RuntimeError("already finalized")
            n_s = len(self._slaves)
            num_dofs = self.V.num_dofs
            if n_s == 0:
                slaves = np.zeros((0,), np.int64)
                masters = np.zeros((0, 1), np.int64)
                coeffs = np.zeros((0, 1), self.dtype)
                is_slave = np.zeros(num_dofs, dtype=bool)
            else:
                slaves = np.asarray(self._slaves, dtype=np.int64)
                if len(np.unique(slaves)) != n_s:
                    raise ValueError("duplicate slave dofs in constraint")
                # compact away explicit zero-coefficient masters (algebraically
                # inert) so that "first k columns are the real masters" holds
                comp = [
                    (np.asarray(m)[np.asarray(c) != 0], np.asarray(c)[np.asarray(c) != 0])
                    for m, c in zip(self._masters, self._coeffs)
                ]
                mm = max(max((len(m) for m, _ in comp), default=1), 1)
                masters = np.zeros((n_s, mm), dtype=np.int64)
                coeffs = np.zeros((n_s, mm), dtype=self.dtype)
                for i, (m, c) in enumerate(comp):
                    masters[i, : len(m)] = m
                    coeffs[i, : len(c)] = c
                is_slave = np.zeros(num_dofs, dtype=bool)
                is_slave[slaves] = True
                if is_slave[masters[coeffs != 0]].any():
                    raise ValueError("a master dof is itself a slave "
                                     "(chained constraints unsupported, as in reference)")
            self._np_slaves = slaves
            self._np_masters = masters
            self._np_coeffs = coeffs
            self._np_is_slave = is_slave
            dev = self.device
            self.finalized = FinalizedMPC(
                torch.as_tensor(slaves, device=dev),
                torch.as_tensor(masters, device=dev),
                torch.as_tensor(coeffs, dtype=torch_dtype(self.dtype), device=dev),
                torch.as_tensor(is_slave, device=dev),
                num_dofs,
            )

    # -- accessors mirroring the reference ------------------------------
    @property
    def function_space(self) -> FunctionSpace:
        return self.V

    @property
    def slaves(self) -> np.ndarray:
        self._require_finalized()
        return self._np_slaves

    @property
    def masters(self):
        """(flat_masters, offsets) CSR view like reference `masters()`."""
        self._require_finalized()
        flat, offs = [], [0]
        for m in self._masters:
            flat.extend(int(x) for x in m)
            offs.append(offs[-1] + len(m))
        return np.asarray(flat, dtype=np.int64), np.asarray(offs, dtype=np.int64)

    @property
    def coefficients(self):
        self._require_finalized()
        flat, offs = [], [0]
        for c in self._coeffs:
            flat.extend(c.tolist())
            offs.append(offs[-1] + len(c))
        return np.asarray(flat, dtype=self.dtype), np.asarray(offs, dtype=np.int64)

    @property
    def is_slave(self) -> np.ndarray:
        self._require_finalized()
        return self._np_is_slave

    @property
    def num_local_slaves(self) -> int:
        self._require_finalized()
        return len(self._np_slaves)

    def cell_to_slaves(self):
        """cells -> slave indices map: per cell, one int64 array of the
        positions in the slave list of the cell's slave dofs, in dofmap order
        (reference MultiPointConstraint.h:66)."""
        self._require_finalized()
        spos = np.full(self.V.num_dofs, -1, dtype=np.int64)
        spos[self._np_slaves] = np.arange(len(self._np_slaves))
        s = spos[self.V.dofmap]
        keep = s >= 0
        # split after every cell's last entry; the piece after the last cell is empty
        return np.split(s[keep], np.cumsum(keep.sum(axis=1)))[:-1]

    # -- kernels --------------------------------------------------------
    def backsubstitution(self, u) -> None:
        """In place on a Function or a tensor."""
        self._require_finalized()
        arr = u.x.array if isinstance(u, Function) else u
        arr.copy_(self.finalized.backsubstitution(arr))

    def homogenize(self, u) -> None:
        self._require_finalized()
        arr = u.x.array if isinstance(u, Function) else u
        arr.copy_(self.finalized.homogenize(arr))

    def _require_finalized(self):
        if self.finalized is None:
            raise RuntimeError("call finalize() first")
