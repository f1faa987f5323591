"""Function spaces and dofmaps.

Numpy host code copied from ``dolfinx_mpc_tpu/fem/functionspace.py`` (the JAX
reference), so that the PyTorch port never imports JAX.

Replacement for the DOLFINx FunctionSpace/DofMap/IndexMap surface
the reference consumes everywhere (reference cpp/mpc_helpers.h:24-31,
cpp/PeriodicConstraint.h:525-555).  Single-address-space design: there is no
owner/ghost IndexMap — the mesh is shared.  Dof blocks are numbered entity-wise; orientation of shared
edge/face interior dofs is resolved by geometric matching of nodal points,
which is robust for any cell order and replaces DOLFINx's permutation codes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .elements import LagrangeElement, lagrange_element
from .mesh import Mesh

__all__ = [
    "FunctionSpace",
    "functionspace",
    "Function",
    "DirichletBC",
    "dirichletbc",
    "locate_dofs_geometrical",
    "locate_dofs_topological",
]


@dataclass
class FunctionSpace:
    """A (possibly blocked/vector) Lagrange space.

    dofmap_blocks: (n_cells, ndofs_scalar) int32 — global dof *block* per
        local scalar basis function.  The unrolled dof index for local node i,
        component k is ``dofmap_blocks[c, i] * bs + k`` (interleaved layout,
        matching DOLFINx's blocked IndexMap convention).
    """

    mesh: Mesh
    element: LagrangeElement
    block_size: int
    dofmap_blocks: np.ndarray
    num_blocks: int
    dof_coords_blocks: np.ndarray  # (num_blocks, gdim)
    entity_dofs_store: dict  # dim -> (n_entities, k) block ids per entity
    # sub-space bookkeeping: if this is V.sub(i), parent is set
    parent: Optional["FunctionSpace"] = None
    component: Optional[int] = None
    # grid-lex numbering metadata for lattice meshes (degree-2 fast path):
    # {"r": refine factor, "gshape": refined dof-grid shape} — dof block of
    # the node at refined-grid coords (i, j, k) is (i*G1 + j)*G2 + k.
    grid_meta: Optional[dict] = None
    # mixed-space field views: this space's dofs live at
    # [dof_offset, dof_offset + num_dofs) of `mixed_parent`
    # (fem/mixed.py; mirrors the reference's sub-space collapse semantics,
    # reference cpp/PeriodicConstraint.h:525-555)
    dof_offset: int = 0
    mixed_parent: Optional[object] = None
    _dofmap_unrolled: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def num_dofs(self) -> int:
        return self.num_blocks * self.block_size

    @property
    def ndofs_cell(self) -> int:
        """Unrolled dofs per cell."""
        return self.element.ndofs * self.block_size

    @property
    def dofmap(self) -> np.ndarray:
        """(n_cells, ndofs_scalar*bs) unrolled int32 dofmap, interleaved."""
        if self._dofmap_unrolled is None:
            bs = self.block_size
            dm = self.dofmap_blocks.astype(np.int64)
            un = (dm[:, :, None] * bs + np.arange(bs)[None, None, :]).reshape(
                dm.shape[0], -1
            )
            object.__setattr__(self, "_dofmap_unrolled", un.astype(np.int32))
        return self._dofmap_unrolled

    def tabulate_dof_coordinates(self) -> np.ndarray:
        """(num_blocks, gdim) coordinates of each dof block (mirrors
        reference cpp/utils.h:1214-1357)."""
        return self.dof_coords_blocks

    def sub(self, i: int) -> "FunctionSpace":
        if not (0 <= i < self.block_size):
            raise ValueError(f"component {i} out of range (bs={self.block_size})")
        return FunctionSpace(
            self.mesh,
            self.element,
            self.block_size,
            self.dofmap_blocks,
            self.num_blocks,
            self.dof_coords_blocks,
            self.entity_dofs_store,
            parent=self,
            component=i,
            grid_meta=self.grid_meta,
            dof_offset=self.dof_offset,
            mixed_parent=self.mixed_parent,
        )

    def collapse(self):
        """Collapse a component sub-space to a standalone scalar space.
        Returns (V_collapsed, parent_unrolled_dofs)."""
        if self.component is None:
            raise ValueError("collapse() only valid on a sub-space")
        Vc = functionspace(self.mesh, (self.element.cell.name, self.element.degree))
        parent_map = np.arange(self.num_blocks, dtype=np.int64) * self.block_size + self.component
        return Vc, parent_map

    def unroll_blocks(self, blocks: np.ndarray) -> np.ndarray:
        """Block indices -> unrolled dof indices (offset into the mixed
        parent for field views).  If this is a component sub-space only that
        component is returned."""
        blocks = np.asarray(blocks, dtype=np.int64)
        if self.component is not None:
            return self.dof_offset + blocks * self.block_size + self.component
        bs = self.block_size
        out = (blocks[:, None] * bs + np.arange(bs)[None, :]).reshape(-1)
        return self.dof_offset + out


def _canonical_entity_dofs(mesh: Mesh, element: LagrangeElement):
    """Assign dof blocks entity-wise; resolve shared edge/face interior dof
    orientation by geometric matching of the nodal points."""
    cell = element.cell
    d = element.degree
    tdim = cell.tdim
    n_cells = mesh.num_cells
    nd = element.ndofs

    # --- P1/Q1 fast path: one dof per vertex in local-vertex order means the
    # dofmap IS the connectivity (zero-copy; the generic path below costs
    # ~40s of strided copies at 60M cells)
    vert_only = element.entity_dofs(0) == [[i] for i in range(cell.num_vertices)] and all(
        len(s) == 0
        for dim in range(1, tdim + 1)
        for s in element.entity_dofs(dim)
    )
    if vert_only and nd == cell.num_vertices:
        dofmap = mesh.cells.astype(np.int32, copy=False)
        entity_store = {0: np.arange(mesh.num_points, dtype=np.int64)[:, None]}
        return dofmap, mesh.num_points, mesh.points, entity_store

    dofmap = np.empty((n_cells, nd), dtype=np.int64)
    # --- vertices
    vert_local = element.entity_dofs(0)  # [[0],[1],...]
    for lv, slots in enumerate(vert_local):
        dofmap[:, slots[0]] = mesh.cells[:, lv]
    next_block = mesh.num_points
    coords_chunks = [mesh.points]
    entity_store = {0: np.arange(mesh.num_points, dtype=np.int64)[:, None]}

    # physical coords of every local node in every cell (geometry is P1/Q1:
    # node coords = affine/multilinear combination of vertex coords) —
    # computed lazily: P1 spaces have no edge/face/interior dofs and this is
    # a 10s+ einsum at 10M-cell scale
    _node_phys_cache = {}

    def node_phys():
        if "v" not in _node_phys_cache:
            geo = lagrange_element(cell.name, 1)
            phi_nodes = geo.tabulate(element.nodes)  # (nd, n_verts)
            cellxyz = mesh.points[mesh.cells]  # (n_cells, n_verts, gdim)
            _node_phys_cache["v"] = np.einsum("nv,cvg->cng", phi_nodes, cellxyz)
        return _node_phys_cache["v"]

    for dim in range(1, tdim + 1):
        if dim == tdim:
            per = len(element.entity_dofs(tdim)[0])
            if per == 0:
                entity_store[tdim] = np.zeros((n_cells, 0), dtype=np.int64)
                continue
            slots = element.entity_dofs(tdim)[0]
            ids = next_block + np.arange(n_cells * per, dtype=np.int64).reshape(n_cells, per)
            dofmap[:, slots] = ids
            next_block += n_cells * per
            coords_chunks.append(node_phys()[:, slots, :].reshape(-1, mesh.gdim))
            entity_store[tdim] = ids
            continue
        ent_local_dofs = element.entity_dofs(dim)
        per = len(ent_local_dofs[0]) if ent_local_dofs else 0
        if per == 0:
            # no dofs on these entities: don't force the (expensive) entity
            # dedup — P1 spaces never need edge/face connectivity here
            entity_store[dim] = np.zeros((0, 0), dtype=np.int64)
            continue
        _, cell_to_ent, _ = mesh.entities(dim)
        n_ent = int(cell_to_ent.max()) + 1 if cell_to_ent.size else 0
        ids = next_block + np.arange(n_ent * per, dtype=np.int64).reshape(n_ent, per)
        entity_store[dim] = ids
        canon = np.full((n_ent, per, mesh.gdim), np.nan)
        have = np.zeros(n_ent, dtype=bool)
        for le, slots in enumerate(ent_local_dofs):
            E = cell_to_ent[:, le]  # (n_cells,)
            pts = node_phys()[:, slots, :]  # (n_cells, per, gdim)
            newmask = ~have[E]
            # first-touch cells define the canonical ordering
            first_idx = np.flatnonzero(newmask)
            # dedupe: only the first cell per entity among the new ones
            _, keep = np.unique(E[first_idx], return_index=True)
            first_idx = first_idx[keep]
            canon[E[first_idx]] = pts[first_idx]
            have[E[first_idx]] = True
            # now match every cell's points against the canonical ones
            diff = pts[:, :, None, :] - canon[E][:, None, :, :]
            d2 = np.einsum("cabg,cabg->cab", diff, diff)
            perm = d2.argmin(axis=2)  # (n_cells, per): local slot -> canonical pos
            dofmap[:, slots] = np.take_along_axis(ids[E], perm, axis=1)
        next_block += n_ent * per
        coords_chunks.append(canon.reshape(-1, mesh.gdim))

    dof_coords = np.concatenate(coords_chunks, axis=0)
    assert dof_coords.shape[0] == next_block
    return dofmap.astype(np.int32), next_block, dof_coords, entity_store


def _lattice_grid_dofs(mesh: Mesh, element: LagrangeElement):
    """Grid-lex dof numbering for degree-2 Lagrange on pristine box lattices.

    On a Kuhn-tet lattice the P2 dofs biject with the (2n+1)^3 refined grid:
    (n+1)^3 vertices + 3n(n+1)^2 axis edges + 3n^2(n+1) face diagonals + n^3
    body diagonals = (2n+1)^3 (same identity in 2D and for Q2 on quads/hexes
    counting face/volume interior nodes).  Numbering dof blocks lex on that
    grid is what lets the DIA stencil fast path (ops/lattice.py) cover the
    reference's canonical --degree 2 benchmark
    (reference python/benchmarks/Makefile:1-9).  Returns
    (dofmap, num_blocks, dof_coords, entity_store, grid_meta) or None.
    """
    from ..ops.lattice import _uniform_lattice_geometry, _vertex_delta_table
    from .lattice_info import get_lattice_info

    lat = get_lattice_info(mesh)
    r = element.degree
    if lat is None or r != 2:
        return None
    geo = _uniform_lattice_geometry(mesh, lat)
    if geo is None:
        return None
    origin, spacing = geo
    tdim = mesh.tdim
    nx, ny, nz = lat.dims
    nzc = 1 if tdim == 2 else nz
    G = (r * nx + 1, r * ny + 1, 1 if tdim == 2 else r * nz + 1)

    # per-(subcell, node) integer deltas on the refined grid: node position
    # in lattice units = sum_v phi_v(node_ref) * vertex_delta (geometry is
    # P1/Q1), scaled by r
    vdeltas = _vertex_delta_table(mesh, lat).astype(np.float64)  # (T, nv, 3)
    geo_el = lagrange_element(mesh.cell_type, 1)
    phi = geo_el.tabulate(element.nodes)  # (nd, nv)
    dd = r * np.einsum("nv,tvd->tnd", phi, vdeltas)
    ddi = np.rint(dd).astype(np.int32)
    if np.abs(dd - ddi).max() > 1e-9:
        return None  # nodes off the refined lattice (non-equispaced variant)

    nd = element.ndofs
    T = lat.cells_per_box
    nb = G[0] * G[1] * G[2]
    # cells are ordered (i, j, k, t); per-axis index parts then one
    # broadcast-add (all int32: nb < 2^31 up to ~2G dofs)
    s12, s2 = np.int32(G[1] * G[2]), np.int32(G[2])
    bi = (np.arange(nx, dtype=np.int32) * r)[:, None, None]
    bj = (np.arange(ny, dtype=np.int32) * r)[:, None, None]
    bk = (np.arange(nzc, dtype=np.int32) * (0 if tdim == 2 else r))[:, None, None]
    px = (bi + ddi[None, :, :, 0]) * s12  # (nx, T, nd)
    py = (bj + ddi[None, :, :, 1]) * s2  # (ny, T, nd)
    pz = bk + ddi[None, :, :, 2]  # (nzc, T, nd)
    dofmap = (
        px[:, None, None] + py[None, :, None] + pz[None, None, :]
    ).reshape(-1, nd)

    # dof coordinates = the refined grid itself
    gdim = mesh.gdim
    coords = np.empty((G[0], G[1], G[2], gdim))
    axes = [origin[d] + (spacing[d] / r) * np.arange(G[d]) for d in range(gdim)]
    coords[..., 0] = axes[0][:, None, None]
    coords[..., 1] = axes[1][None, :, None]
    if gdim == 3:
        coords[..., 2] = axes[2][None, None, :]
    coords = coords.reshape(nb, gdim)

    # vertex -> block map (store[0]); higher-dim interior dofs are built
    # lazily by _ensure_entity_store (degree 2: one node per entity centroid)
    vi = (np.arange(nx + 1, dtype=np.int64) * r)[:, None, None] * int(s12)
    vj = (np.arange(ny + 1, dtype=np.int64) * r)[None, :, None] * int(s2)
    vk = (np.arange(1 if tdim == 2 else nz + 1, dtype=np.int64) * (0 if tdim == 2 else r))[None, None, :]
    store0 = (vi + vj + vk).reshape(-1, 1)
    meta = {"r": r, "gshape": G}
    return dofmap, nb, coords, {0: store0}, meta


def _ensure_entity_store(V: FunctionSpace, dim: int):
    """Lazily populate entity_dofs_store[dim] for grid-numbered spaces:
    degree 2 has exactly one interior node per entity, at its centroid."""
    store = V.entity_dofs_store
    if dim in store or V.grid_meta is None or dim == 0:
        return
    ent_dofs = V.element.entity_dofs(dim)
    per = len(ent_dofs[0]) if ent_dofs else 0
    if per == 0:
        store[dim] = np.zeros((0, 0), dtype=np.int64)
        return
    assert per == 1, "grid numbering only supports degree <= 2"
    mesh = V.mesh
    r = V.grid_meta["r"]
    G = V.grid_meta["gshape"]
    if dim == mesh.tdim:
        vids = mesh.cells
    else:
        vids, _, _ = mesh.entities(dim)
    # vertex integer lattice coords from lex vertex ids
    from .lattice_info import get_lattice_info

    lat = get_lattice_info(mesh)
    nx, ny, nz = lat.dims
    n1v = ny + 1
    n2v = max(nz + 1, 1)
    v = vids.astype(np.int64)
    k = v % n2v
    j = (v // n2v) % n1v
    i = v // (n2v * n1v)
    nv_e = vids.shape[1]
    cen = []
    for comp in (i, j, k):
        s = r * comp.sum(axis=1)
        assert (s % nv_e == 0).all(), "entity centroid off the refined grid"
        cen.append(s // nv_e)
    idx = (cen[0] * G[1] + cen[1]) * G[2] + cen[2]
    store[dim] = idx[:, None]


def functionspace(mesh: Mesh, element_spec, shape=None) -> FunctionSpace:
    """Create a function space.

    element_spec: ("Lagrange", degree) | (cell_name, degree) | ("Lagrange",
    degree, (gdim,)) for a vector space — mirrors
    ``dolfinx.fem.functionspace`` usage in the reference demos.
    """
    if len(element_spec) == 3 and shape is None:
        shape = element_spec[2]
    degree = element_spec[1]
    element = lagrange_element(mesh.cell_type, degree)
    bs = 1 if shape is None else int(np.prod(shape))
    grid = _lattice_grid_dofs(mesh, element)
    if grid is not None:
        dofmap, nblocks, coords, store, meta = grid
        return FunctionSpace(mesh, element, bs, dofmap, nblocks, coords, store,
                             grid_meta=meta)
    dofmap, nblocks, coords, store = _canonical_entity_dofs(mesh, element)
    return FunctionSpace(mesh, element, bs, dofmap, nblocks, coords, store)


# ---- functions -----------------------------------------------------------


class Function:
    """A finite-element function: flat dof vector of length num_dofs, held as
    a torch tensor in ``x.array`` on an explicit device."""

    def __init__(self, V: FunctionSpace, x=None, name: str = "f", dtype=None, device="cuda"):
        import torch

        from .._device import resolve_device
        from .._dtypes import torch_dtype

        device = resolve_device(device)

        self.function_space = V
        self.name = name
        dt = torch_dtype(np.float64 if dtype is None else dtype)
        arr = (torch.zeros(V.num_dofs, dtype=dt, device=device) if x is None
               else torch.as_tensor(x, dtype=dt, device=device).clone())
        self.x = _VecShim(arr)

    @property
    def V(self):
        return self.function_space

    def interpolate(self, f: Callable):
        """Pointwise nodal interpolation: f takes x of shape (gdim, n) and
        returns (n,) for scalar spaces or (bs, n) for blocked spaces."""
        import torch

        V = self.function_space
        coords = V.dof_coords_blocks  # (nb, gdim)
        vals = np.asarray(f(coords.T))
        bs = V.block_size
        if bs == 1:
            flat = vals.reshape(-1)
        else:
            if vals.shape != (bs, coords.shape[0]):
                raise ValueError(f"expected ({bs}, {coords.shape[0]}), got {vals.shape}")
            flat = vals.T.reshape(-1)
        arr = self.x.array
        arr.copy_(torch.as_tensor(flat, dtype=arr.dtype, device=arr.device))
        return self

    def copy(self):
        arr = self.x.array
        return Function(self.function_space, arr, self.name, arr.dtype, arr.device)

    def eval(self, points: np.ndarray, cells=None):
        """Evaluate at physical points (host-side; for tests/demos)."""
        from .geometry_maps import PointLocator, _tabulate_rows

        V = self.function_space
        pts = np.atleast_2d(points)
        loc = PointLocator(V.mesh)
        cid, X = loc.locate(pts)
        if (cid < 0).any():
            raise ValueError("point outside mesh")
        phi = _tabulate_rows(V.element, X)  # (n, ndofs_scalar)
        dm = V.dofmap_blocks[cid]  # (n, ndofs_scalar)
        bs = V.block_size
        arr = self.x.array.detach().cpu().numpy()
        out = np.zeros((pts.shape[0], bs), dtype=arr.dtype)
        for k in range(bs):
            out[:, k] = np.einsum("ni,ni->n", phi, arr[dm * bs + k])
        return out[:, 0] if bs == 1 else out


class _VecShim:
    """Mimics dolfinx's Function.x (has .array, a torch tensor)."""

    def __init__(self, arr):
        self.array = arr

    def scatter_forward(self):  # single address space: no-op
        pass

    def scatter_reverse(self, *_):
        pass


# ---- boundary conditions -------------------------------------------------


@dataclass
class DirichletBC:
    """Dirichlet condition on unrolled dof indices.

    value: scalar, array broadcastable over dofs, or a Function whose dof
    values are sampled at `dofs`.
    """

    dofs: np.ndarray  # unrolled dof indices, int
    value: object
    V: FunctionSpace

    def dof_values(self, dtype=np.float64) -> np.ndarray:
        if isinstance(self.value, Function):
            # bc dofs are parent-global; the value Function lives either on
            # the same offset field view (subtract its own offset), on the
            # full mixed parent (index directly), or on a collapsed/base
            # sub-space — what split() returns — in which case the BC
            # space's offset maps parent-global -> field-local
            vs = self.value.function_space
            voff = getattr(vs, "dof_offset", 0)
            if not voff:
                parent = getattr(self.V, "mixed_parent", None)
                on_parent = parent is not None and (
                    vs is parent or vs.num_dofs == parent.num_dofs)
                if not on_parent:
                    voff = getattr(self.V, "dof_offset", 0)
            idx = self.dofs - voff
            arr = self.value.x.array.detach().cpu().numpy()
            if len(idx) and (idx.min() < 0 or idx.max() >= len(arr)):
                raise ValueError(
                    "DirichletBC value Function does not cover the bc dofs: "
                    f"mapped index range [{idx.min()}, {idx.max()}] vs value "
                    f"array of length {len(arr)} (dof_offset mismatch between "
                    "the bc space and the value's function space?)")
            return arr[idx].astype(dtype)
        v = np.asarray(self.value, dtype=dtype)
        if v.ndim == 0:
            return np.full(len(self.dofs), v, dtype=dtype)
        # constant vector value: broadcast per block component (field views
        # of a mixed space carry a dof_offset into the parent numbering)
        bs = self.V.block_size
        comp = (self.dofs - self.V.dof_offset) % bs
        return v[comp]


def dirichletbc(value, dofs, V: FunctionSpace = None) -> DirichletBC:
    """Mirror of ``dolfinx.fem.dirichletbc``: `dofs` are *block* indices as
    returned by locate_dofs_*; they are unrolled here."""
    if V is None:
        if not isinstance(value, Function):
            raise ValueError("V required unless value is a Function")
        V = value.function_space
    dofs = np.asarray(dofs, dtype=np.int64)
    space = V if V.component is None else V  # sub-space: single component
    unrolled = space.unroll_blocks(dofs)
    base = V if V.parent is None else V.parent
    return DirichletBC(np.unique(unrolled), value, base)


def locate_dofs_geometrical(V: FunctionSpace, marker) -> np.ndarray:
    """Dof blocks whose coordinates satisfy marker(x) with x (gdim, n)."""
    mask = np.asarray(marker(V.dof_coords_blocks.T))
    return np.flatnonzero(mask).astype(np.int64)


def locate_dofs_topological(V: FunctionSpace, dim: int, entities) -> np.ndarray:
    """Dof blocks attached to the closure of the given entities."""
    entities = np.asarray(entities, dtype=np.int64)
    mesh = V.mesh
    store = V.entity_dofs_store
    for d in range(1, dim + 1):
        _ensure_entity_store(V, d)
    blocks = []
    # entity's own interior dofs
    if dim in store and store[dim].size:
        blocks.append(store[dim][entities].reshape(-1))
    # closure: vertices and lower-dim entities of each entity
    if dim > 0:
        ent_verts, _, _ = mesh.entities(dim)
        vs = ent_verts[entities]
        blocks.append(store[0][vs.reshape(-1)].reshape(-1))
        if dim >= 2 and 1 in store and store[1].size:
            # edges of these entities: find global edge ids by vertex pairs
            edge_verts, _, _ = mesh.entities(1)
            edge_lookup = {tuple(sorted(e)): i for i, e in enumerate(edge_verts.tolist())}
            sub_edges = set()
            for row in vs:
                row = row.tolist()
                n = len(row)
                if dim == 2 and n == 4:
                    pairs = [(0, 1), (0, 2), (1, 3), (2, 3)]
                elif dim == 2 and n == 3:
                    pairs = [(0, 1), (0, 2), (1, 2)]
                else:
                    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
                for a, b in pairs:
                    key = tuple(sorted((row[a], row[b])))
                    if key in edge_lookup:
                        sub_edges.add(edge_lookup[key])
            if sub_edges:
                blocks.append(store[1][sorted(sub_edges)].reshape(-1))
    out = np.unique(np.concatenate(blocks)) if blocks else np.array([], dtype=np.int64)
    return out.astype(np.int64)
