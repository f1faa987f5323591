"""Mixed function spaces: several fields (each its own element/block size)
in ONE space, ONE matrix.

Numpy host code copied from ``dolfinx_mpc_tpu/fem/mixed.py`` (the JAX
reference), so that the PyTorch port never imports JAX; ``split`` views the
mixed Function's tensor.  Replacement for DOLFINx MixedElement spaces as
consumed by the reference (sub-space collapse in the constraint generators,
reference cpp/PeriodicConstraint.h:509-572; single-matrix Taylor-Hood
Stokes in python/demos/demo_stokes.py; mixed-space periodic tests,
python/tests/test_periodic.py:11-14).

Design: dofs are FIELD-STACKED — field f owns the contiguous global range
[offset_f, offset_f + V_f.num_dofs).  `sub(f)` returns the field's own
uniform FunctionSpace carrying `dof_offset=offset_f`, so every existing
consumer (constraint generators, DirichletBC, locate_dofs_*) works on field
views unchanged — they unroll block indices through `unroll_blocks`, which
applies the offset.  The per-cell dofmap is the concatenation of per-field
unrolled dofmaps, so the general slot-CSR assembler and all MPC machinery
work untouched; only the element kernels need mixed basis tables
(ops/kernels.py: per-field Args, zero off-field rows).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .functionspace import Function, FunctionSpace, _VecShim, functionspace

__all__ = ["MixedElement", "MixedFunctionSpace", "mixed_functionspace", "split"]


@dataclass
class MixedElement:
    """Duck-typed 'element' of a mixed space (degree used for quadrature
    defaults; ndofs is the unrolled per-cell count)."""

    elements: tuple  # per-field LagrangeElement
    block_sizes: tuple

    @property
    def degree(self) -> int:
        return max(e.degree for e in self.elements)

    @property
    def ndofs(self) -> int:
        return sum(e.ndofs * b for e, b in zip(self.elements, self.block_sizes))

    @property
    def cell(self):
        return self.elements[0].cell


class MixedFunctionSpace:
    """Field-stacked mixed space.  Implements the FunctionSpace surface the
    assembly/MPC layers consume (mesh, num_dofs, dofmap, ndofs_cell)."""

    is_mixed = True
    parent = None
    component = None
    grid_meta = None
    dof_offset = 0
    mixed_parent = None
    block_size = 1  # unrolled layout; fields carry their own block sizes

    def __init__(self, spaces, names: Optional[list] = None):
        assert len(spaces) >= 1
        mesh = spaces[0].mesh
        for W in spaces:
            assert W.mesh is mesh, "all fields must share the mesh"
            assert W.parent is None and W.mixed_parent is None
        self.mesh = mesh
        self.spaces = tuple(spaces)
        self.names = tuple(names) if names is not None else tuple(
            f"field{i}" for i in range(len(spaces))
        )
        self.offsets = np.concatenate(
            [[0], np.cumsum([W.num_dofs for W in spaces])]
        ).astype(np.int64)
        self.num_dofs = int(self.offsets[-1])
        self.num_blocks = self.num_dofs
        self.element = MixedElement(
            tuple(W.element for W in spaces), tuple(W.block_size for W in spaces)
        )
        self._dofmap = None
        self._views = [None] * len(spaces)
        self._dof_coords = None

    @property
    def num_fields(self) -> int:
        return len(self.spaces)

    @property
    def ndofs_cell(self) -> int:
        return self.element.ndofs

    @property
    def dofmap(self) -> np.ndarray:
        """(n_cells, sum_f nd_f*bs_f) unrolled global dofmap: per-field
        unrolled dofmaps shifted by the field offsets, concatenated in field
        order (the local ordering the mixed kernels use)."""
        if self._dofmap is None:
            parts = [
                (W.dofmap.astype(np.int64) + self.offsets[f]).astype(np.int32)
                for f, W in enumerate(self.spaces)
            ]
            self._dofmap = np.concatenate(parts, axis=1)
        return self._dofmap

    @property
    def dof_coords_blocks(self) -> np.ndarray:
        """Per-dof coordinates (unrolled: block coords repeated per
        component within each field)."""
        if self._dof_coords is None:
            parts = [
                np.repeat(W.dof_coords_blocks, W.block_size, axis=0)
                for W in self.spaces
            ]
            self._dof_coords = np.concatenate(parts, axis=0)
        return self._dof_coords

    def field_slice(self, i: int) -> slice:
        return slice(int(self.offsets[i]), int(self.offsets[i + 1]))

    def sub(self, i: int) -> FunctionSpace:
        """Field view: the field's own uniform FunctionSpace with dofs
        offset into this space's numbering (reference sub-space semantics —
        constraints/BCs built on it land in the mixed numbering)."""
        if not (0 <= i < len(self.spaces)):
            raise ValueError(f"field {i} out of range")
        if self._views[i] is None:
            W = self.spaces[i]
            self._views[i] = FunctionSpace(
                W.mesh,
                W.element,
                W.block_size,
                W.dofmap_blocks,
                W.num_blocks,
                W.dof_coords_blocks,
                W.entity_dofs_store,
                grid_meta=W.grid_meta,
                dof_offset=int(self.offsets[i]),
                mixed_parent=self,
            )
        return self._views[i]

    def unroll_blocks(self, blocks: np.ndarray) -> np.ndarray:
        # mixed "blocks" are unrolled dofs already (block_size 1)
        return np.asarray(blocks, dtype=np.int64)

    def tabulate_dof_coordinates(self) -> np.ndarray:
        return self.dof_coords_blocks


def mixed_functionspace(mesh, field_specs, names=None) -> MixedFunctionSpace:
    """field_specs: list of element specs as accepted by ``functionspace``,
    e.g. [("Lagrange", 2, (3,)), ("Lagrange", 1)] for 3D Taylor-Hood."""
    spaces = [functionspace(mesh, spec) for spec in field_specs]
    return MixedFunctionSpace(spaces, names)


def split(u: Function):
    """Per-field sub-Functions VIEWING the mixed Function's dof vector
    (tensor slices share its storage, on its device — mirrors ufl.split +
    collapse usage in the reference demos)."""
    V = u.function_space
    assert isinstance(V, MixedFunctionSpace), "split() needs a mixed-space Function"
    out = []
    for f, W in enumerate(V.spaces):
        uf = Function.__new__(Function)
        uf.function_space = W
        uf.name = f"{u.name}_{V.names[f]}"
        uf.x = _VecShim(u.x.array[V.field_slice(f)])
        out.append(uf)
    return tuple(out)
