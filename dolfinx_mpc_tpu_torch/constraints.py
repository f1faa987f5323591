"""Constraint generators: the periodic pair and tied (inelastic) contact
(numpy host code).

Copied from ``dolfinx_mpc_tpu/constraints.py:39-146, 183-199, 247-289`` (the
JAX reference), so that the PyTorch port never imports JAX.  Slip, contact
slip, dictionary and point-to-point generators come with ROADMAP queue 1,
item 17.

Rebuild of the reference's generator layer (SURVEY.md L2):
- periodic: reference cpp/PeriodicConstraint.h:30-490 — dof coords are
  mapped through the user relation and masters come from basis evaluation at
  the mapped point.  The reference's two-phase MPI alltoall dance
  (:223-481) disappears: one address space, one host-side point-location pass.

All generators run once at setup on the host (numpy) and return a flat
`MPCData`; the hot path only ever sees the finalized padded tables.
"""

from __future__ import annotations

import numpy as np

from .fem.functionspace import FunctionSpace, locate_dofs_topological
from .fem.geometry_maps import PointLocator, _tabulate_rows
from .fem.mesh import MeshTags
from .multipointconstraint import MPCData

__all__ = [
    "create_contact_inelastic_condition",
    "create_periodic_condition_geometrical",
    "create_periodic_condition_topological",
]


def _bc_dof_set(bcs):
    out = set()
    for bc in bcs:
        out.update(int(d) for d in bc.dofs)
    return out


def _basis_masters(V: FunctionSpace, points: np.ndarray, locator: PointLocator, tol=1e-9):
    """Evaluate basis at physical points: returns (cells, block_dofs (n, nd),
    phi (n, nd)) — the master candidates for each point (reference
    `evaluate_basis_functions`, cpp/utils.h:963-1200)."""
    cells, X = locator.locate(points, tol=tol)
    if (cells < 0).any():
        missing = np.flatnonzero(cells < 0)
        raise RuntimeError(
            f"no colliding cell found for {len(missing)} points, e.g. {points[missing[:3]]}"
            " (reference raises the same, ContactConstraint.h:504-508)"
        )
    phi = _tabulate_rows(V.element, X)  # (n, nd)
    blocks = V.dofmap_blocks[cells]  # (n, nd)
    return cells, blocks, phi


def _shift_mpc(data: MPCData, off: int) -> MPCData:
    """Shift field-local dof indices into the mixed-parent numbering
    (field views carry dof_offset, fem/mixed.py — the reference's sub-space
    collapse semantics, PeriodicConstraint.h:525-555)."""
    if off == 0:
        return data
    return MPCData(
        data.slaves + off, data.masters + off, data.coeffs, data.owners, data.offsets
    )


def _periodic_from_slave_blocks(V, slave_blocks, components, relation, bcs, scale, dtype):
    """Shared tail of the periodic generators: map slave dof coords through
    `relation`, evaluate basis at the image, build the CSR data
    (PeriodicConstraint.h:104-222).

    Fast path for matching meshes: mapped points that coincide with existing
    dof coordinates (cKDTree lookup) get that dof directly as their single
    master — replacing the reference's BB-tree collision + basis evaluation
    (SURVEY.md §7 step 5); only unmatched points go through the general
    Newton pull-back point locator."""
    bc_dofs = _bc_dof_set(bcs)
    bs = V.block_size
    off = getattr(V, "dof_offset", 0)
    coords = V.dof_coords_blocks[slave_blocks]  # (nb, gdim)
    mapped = np.asarray(relation(coords.T)).T[:, : V.mesh.gdim]  # (nb, gdim)
    nb = len(slave_blocks)
    nd = V.element.ndofs
    mblocks = np.zeros((nb, nd), dtype=np.int64)
    phi = np.zeros((nb, nd))
    from scipy.spatial import cKDTree

    tree = cKDTree(V.dof_coords_blocks)
    dist, nearest = tree.query(mapped, k=1)
    hit = dist < 1e-10
    mblocks[hit, 0] = nearest[hit]
    phi[hit, 0] = 1.0
    if (~hit).any():
        locator = PointLocator(V.mesh)
        _, mb_gen, phi_gen = _basis_masters(V, mapped[~hit], locator)
        mblocks[~hit] = mb_gen
        phi[~hit] = phi_gen
    slaves, masters, coeffs, offsets = [], [], [], [0]
    drop_tol = 1e-13
    for i, sb in enumerate(slave_blocks):
        keep = np.abs(phi[i]) > drop_tol
        mb = mblocks[i][keep]
        ph = phi[i][keep]
        for k in components:
            sdof = int(sb) * bs + k
            if sdof + off in bc_dofs:
                continue
            slaves.append(sdof)
            masters.extend((mb * bs + k).tolist())
            coeffs.extend((scale * ph).tolist())
            offsets.append(len(masters))
    return _shift_mpc(MPCData(
        np.asarray(slaves, np.int64),
        np.asarray(masters, np.int64),
        np.asarray(coeffs, dtype),
        np.zeros(len(masters), np.int32),
        np.asarray(offsets, np.int64),
    ), off)


def create_periodic_condition_geometrical(V, indicator, relation, bcs, scale=1.0, dtype=np.float64):
    """Geometrical periodic MPC (PeriodicConstraint.h:509-572): slaves are the
    dof blocks whose coordinates satisfy `indicator`."""
    base = V if V.parent is None else V.parent
    coords = base.dof_coords_blocks
    mask = np.asarray(indicator(coords.T)).astype(bool)
    slave_blocks = np.flatnonzero(mask)
    components = [V.component] if V.component is not None else list(range(base.block_size))
    return _periodic_from_slave_blocks(base, slave_blocks, components, relation, bcs, scale, dtype)


def create_periodic_condition_topological(V, meshtag: MeshTags, tag: int, relation, bcs, scale=1.0, dtype=np.float64):
    """Topological periodic MPC (PeriodicConstraint.h:592-658): slaves are the
    dofs on the tagged facets."""
    base = V if V.parent is None else V.parent
    facets = meshtag.find(tag)
    slave_blocks = locate_dofs_topological(base, meshtag.dim, facets)
    components = [V.component] if V.component is not None else list(range(base.block_size))
    return _periodic_from_slave_blocks(base, slave_blocks, components, relation, bcs, scale, dtype)


def _facet_cells(mesh, facets):
    _, _, f2c = mesh.facets()
    cells = np.unique(f2c[facets].ravel())
    return cells[cells >= 0]


def _locate_with_fallback(V, pts, master_cells, eps2):
    """Collision search with growing tolerance, mirroring the reference's
    bbox padding by eps (ContactConstraint.h:58-161)."""
    locator = PointLocator(V.mesh, master_cells)
    for tol in (1e-12, 1e-9, 1e-6, max(np.sqrt(eps2), 1e-6)):
        try:
            return _basis_masters(V, pts, locator, tol=tol)
        except RuntimeError:
            continue
    return _basis_masters(V, pts, locator, tol=1e-3)


def create_contact_inelastic_condition(V, meshtags: MeshTags, slave_marker, master_marker, eps2=1e-20,
                                       allow_missing_masters=False, dtype=np.float64):
    """Tied contact u_s = u_m componentwise (ContactConstraint.h:906-1780):
    every component of every slave block is a slave with masters
    phi_j(x_s) per matching component."""
    base = V if V.parent is None else V.parent
    off = getattr(base, "dof_offset", 0)
    bs = base.block_size
    mesh = base.mesh
    s_facets = meshtags.find(slave_marker)
    m_facets = meshtags.find(master_marker)
    s_blocks = locate_dofs_topological(base, meshtags.dim, s_facets)
    pts = base.dof_coords_blocks[s_blocks]
    mcells = _facet_cells(mesh, m_facets)
    try:
        _, mblocks, phi = _locate_with_fallback(base, pts, mcells, eps2)
    except RuntimeError:
        if not allow_missing_masters:
            raise
        # locate point-by-point, skipping misses (ContactConstraint.h:903-912)
        locator = PointLocator(mesh, mcells)
        cells, X = locator.locate(pts, tol=max(np.sqrt(eps2), 1e-6))
        ok = cells >= 0
        s_blocks = s_blocks[ok]
        phi = _tabulate_rows(base.element, X[ok])
        mblocks = base.dofmap_blocks[cells[ok]]
    slaves, masters, coeffs, offsets = [], [], [], [0]
    drop_tol = 1e-13
    for i, b in enumerate(s_blocks):
        keep = np.abs(phi[i]) > drop_tol
        mb = mblocks[i][keep]
        ph = phi[i][keep]
        for k in range(bs):
            slaves.append(int(b) * bs + k)
            masters.extend((mb * bs + k).tolist())
            coeffs.extend(ph.tolist())
            offsets.append(len(masters))
    return _shift_mpc(MPCData(
        np.asarray(slaves, np.int64),
        np.asarray(masters, np.int64),
        np.asarray(coeffs, dtype),
        np.zeros(len(masters), np.int32),
        np.asarray(offsets, np.int64),
    ), off)
