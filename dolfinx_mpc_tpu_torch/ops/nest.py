"""Block ("nest") assembly: block matrices and vectors over lists of forms
(torch).

Counterpart of ``dolfinx_mpc_tpu/ops/nest.py`` (the reference's PETSc
MATNEST support, used for Stokes-type systems in demo_stokes_nest): a
NestMatrix is a 2-D grid of assembled blocks (slot CSR, or BELL after
``to_bell``, whose every block matvec is one K8 launch on the card) with a
matvec over the concatenated dof vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..fem.forms import Form
from .assemble import assemble_matrix, assemble_vector

__all__ = ["NestMatrix", "NestVector", "create_matrix_nest", "assemble_matrix_nest", "create_vector_nest",
           "assemble_vector_nest", "block_diag_preconditioner"]


@dataclass
class NestMatrix:
    blocks: list  # 2D list of CSRMatrix / BellMatrix or None
    row_sizes: list
    col_sizes: list

    def _like(self):
        """A tensor of the blocks' dtype and device."""
        for row in self.blocks:
            for B in row:
                if B is not None:
                    return B.diagonal()
        raise ValueError("NestMatrix: no assembled block")

    def matvec(self, x):
        xs = self.split(x)
        out = []
        for i, row in enumerate(self.blocks):
            acc = None
            for j, B in enumerate(row):
                if B is not None:
                    y = B.matvec(xs[j])
                    acc = y if acc is None else acc + y
            out.append(acc if acc is not None else x.new_zeros(self.row_sizes[i]))
        return torch.cat(out)

    def split(self, x):
        xs, off = [], 0
        for n in self.col_sizes:
            xs.append(x[off: off + n])
            off += n
        return xs

    def diagonal(self):
        like = self._like()
        out = []
        for i, row in enumerate(self.blocks):
            B = row[i]
            out.append(B.diagonal() if B is not None else like.new_ones(self.row_sizes[i]))
        return torch.cat(out)

    def to_scipy(self):
        import scipy.sparse as sp

        rows = []
        for i, row in enumerate(self.blocks):
            cols = []
            for j, B in enumerate(row):
                cols.append(B.to_scipy() if B is not None else sp.csr_matrix((self.row_sizes[i], self.col_sizes[j])))
            rows.append(cols)
        return sp.bmat(rows, format="csr")

    def to_bell(self) -> "NestMatrix":
        """The same nest with every block converted to BELL (la/bell.py) on
        its device and in its dtype: on the card each block matvec is then
        one K8 launch."""
        from .._dtypes import numpy_dtype

        def conv(B):
            return None if B is None else B.to_bell(dtype=numpy_dtype(B.data.dtype))

        return NestMatrix([[conv(B) for B in row] for row in self.blocks], list(self.row_sizes),
                          list(self.col_sizes))


class NestVector:
    """Concatenated block vector with sub-vector parts."""

    def __init__(self, parts):
        self.parts = list(parts)

    @property
    def array(self):
        return torch.cat(self.parts)

    def __iter__(self):
        return iter(self.parts)


def create_matrix_nest(a: List[List[Optional[Form]]], constraints) -> NestMatrix:
    """Shape-only creation; assembly happens in assemble_matrix_nest."""
    row_sizes = [c.V.num_dofs for c in constraints]
    return NestMatrix([[None for _ in constraints] for _ in constraints], row_sizes, list(row_sizes))


def assemble_matrix_nest(A: NestMatrix, a, constraints, bcs=None, diagval=1.0) -> NestMatrix:
    """Assemble every block with its (row, col) constraint pair, in the row
    constraint's dtype and on its device; a block takes the bcs whose space
    is its test or trial space."""
    bcs = bcs or []
    for i, row in enumerate(a):
        for j, form in enumerate(row):
            if form is None:
                continue
            bij = [bc for bc in bcs if bc.V is form.test_space or bc.V is form.trial_space]
            A.blocks[i][j] = assemble_matrix(form, (constraints[i], constraints[j]), bij, diagval=diagval,
                                             dtype=constraints[i].dtype)
    return A


def block_diag_preconditioner(parts, sizes):
    """Block-diagonal preconditioner for nest systems: `parts` is one callable
    per block applied to that block's residual slice (e.g. Chebyshev on the
    velocity block and pressure-mass Jacobi for Stokes, the fieldsplit recipe
    of the reference's demo_stokes_nest)."""
    offsets = np.cumsum([0] + list(sizes))

    def M(r):
        return torch.cat([parts[i](r[offsets[i]: offsets[i + 1]]) for i in range(len(parts))])

    return M


def create_vector_nest(L, constraints) -> NestVector:
    from .._dtypes import torch_dtype

    return NestVector([torch.zeros(c.V.num_dofs, dtype=torch_dtype(c.dtype), device=c.device)
                       for c in constraints])


def assemble_vector_nest(b: NestVector, L, constraints) -> NestVector:
    for i, form in enumerate(L):
        b.parts[i] = assemble_vector(form, constraints[i], dtype=constraints[i].dtype)
    return b
