"""I/O: XDMF/HDF5 output and Gmsh MSH input.

The reference writes meshes/solutions through dolfinx.io.XDMFFile (e.g.
bench_periodic.py:172-186) and builds its demo meshes with gmsh
(create_and_export_mesh.py).  This module provides the same surfaces without
external FEM dependencies: an XDMF3+HDF5 writer readable by ParaView, and a
Gmsh 4.1 ASCII reader producing `Mesh` + `MeshTags`.

Copied from ``dolfinx_mpc_tpu/io.py`` (host numpy, no JAX); the one change
is that ``write_function`` reads the port's tensor values back to the
host.  h5py is imported only when an XDMF file is closed.
"""

from __future__ import annotations

import os

import numpy as np

from .fem.mesh import Mesh, MeshTags, meshtags

__all__ = ["XDMFFile", "read_gmsh", "write_gmsh"]

_XDMF_CELL = {
    "triangle": ("Triangle", 3),
    "quadrilateral": ("Quadrilateral", 4),
    "tetrahedron": ("Tetrahedron", 4),
    "hexahedron": ("Hexahedron", 8),
    "interval": ("Polyline", 2),
}

# XDMF hex ordering differs from our lexicographic corner order
_VTK_PERM = {
    "hexahedron": [0, 1, 3, 2, 4, 5, 7, 6],
    "quadrilateral": [0, 1, 3, 2],
}


class XDMFFile:
    """Minimal XDMF3 writer (heavy data in a sibling .h5)."""

    def __init__(self, filename: str, mode: str = "w"):
        assert mode == "w", "reader not implemented"
        self.filename = filename
        self.h5name = os.path.splitext(filename)[0] + ".h5"
        self._mesh = None
        self._fields = []

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def write_mesh(self, mesh: Mesh):
        self._mesh = mesh

    def write_function(self, u, t: float = 0.0, name=None):
        self._fields.append((name or u.name, u.x.array.detach().cpu().numpy().copy(),
                             u.function_space.block_size, float(t)))

    def close(self):
        import h5py

        mesh = self._mesh
        assert mesh is not None, "write_mesh first"
        topo_name, nv = _XDMF_CELL[mesh.cell_type]
        cells = mesh.cells
        if mesh.cell_type in _VTK_PERM:
            cells = cells[:, _VTK_PERM[mesh.cell_type]]
        pts = mesh.points
        if pts.shape[1] == 2:
            pts = np.concatenate([pts, np.zeros((len(pts), 1))], axis=1)
        with h5py.File(self.h5name, "w") as h5:
            h5.create_dataset("mesh/points", data=pts)
            h5.create_dataset("mesh/cells", data=cells.astype(np.int64))
            for fname, arr, bs, t in self._fields:
                h5.create_dataset(f"func/{fname}", data=np.real(arr).reshape(-1, bs))
        h5rel = os.path.basename(self.h5name)
        parts = [
            '<?xml version="1.0"?>',
            '<Xdmf Version="3.0"><Domain>',
            '<Grid Name="mesh" GridType="Uniform">',
            f'<Topology TopologyType="{topo_name}" NumberOfElements="{mesh.num_cells}">',
            f'<DataItem Dimensions="{mesh.num_cells} {nv}" Format="HDF">{h5rel}:/mesh/cells</DataItem>',
            "</Topology>",
            '<Geometry GeometryType="XYZ">',
            f'<DataItem Dimensions="{mesh.num_points} 3" Format="HDF">{h5rel}:/mesh/points</DataItem>',
            "</Geometry>",
        ]
        for fname, arr, bs, t in self._fields:
            atype = "Scalar" if bs == 1 else "Vector"
            nbl = len(arr) // bs
            parts += [
                f'<Attribute Name="{fname}" AttributeType="{atype}" Center="Node">',
                f'<DataItem Dimensions="{nbl} {bs}" Format="HDF">{h5rel}:/func/{fname}</DataItem>',
                "</Attribute>",
            ]
        parts += ["</Grid>", "</Domain></Xdmf>"]
        with open(self.filename, "w") as f:
            f.write("\n".join(parts))


_GMSH_CELL = {2: ("triangle", 3), 3: ("quadrilateral", 4), 4: ("tetrahedron", 4), 5: ("hexahedron", 8),
              1: ("interval", 2)}
_FACET_OF = {"tetrahedron": "triangle", "triangle": "interval",
             "hexahedron": "quadrilateral", "quadrilateral": "interval"}


def read_gmsh(path: str, cell_type: str = None):
    """Read a Gmsh 4.1 ASCII .msh file.

    Returns (mesh, cell_tags, facet_tags) — the surface the reference demos
    get from dolfinx.io.gmshio.model_to_mesh."""
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0

    def until(tag):
        nonlocal i
        while i < len(lines) and lines[i].strip() != tag:
            i += 1
        i += 1

    # entity -> physical tag map
    until("$Entities")
    counts = list(map(int, lines[i].split()))
    i += 1
    ent_phys = {}
    for dim, cnt in enumerate(counts):
        for _ in range(cnt):
            parts = lines[i].split()
            i += 1
            tag = int(parts[0])
            nb = int(parts[7 if dim else 4]) if dim else int(parts[4])
            phys = int(parts[8 if dim else 5]) if nb > 0 else 0
            ent_phys[(dim, tag)] = phys
    until("$Nodes")
    nblocks, nnodes = int(lines[i].split()[0]), int(lines[i].split()[1])
    i += 1
    coords = np.zeros((nnodes + 1, 3))
    for _ in range(nblocks):
        _, _, _, num = map(int, lines[i].split())
        i += 1
        ids = [int(lines[i + k]) for k in range(num)]
        i += num
        for k in range(num):
            coords[ids[k]] = list(map(float, lines[i + k].split()[:3]))
        i += num
    until("$Elements")
    nblocks = int(lines[i].split()[0])
    i += 1
    elems = {}  # cell_name -> (conn list, phys list)
    for _ in range(nblocks):
        edim, etag, etype, num = map(int, lines[i].split())
        i += 1
        phys = ent_phys.get((edim, etag), 0)
        if etype in _GMSH_CELL:
            name, nv = _GMSH_CELL[etype]
            conn, ph = elems.setdefault(name, ([], []))
            for k in range(num):
                parts = lines[i + k].split()
                conn.append([int(x) - 1 for x in parts[1 : 1 + nv]])
                ph.append(phys)
        i += num

    if cell_type is None:
        for cand in ("tetrahedron", "hexahedron", "triangle", "quadrilateral"):
            if cand in elems:
                cell_type = cand
                break
    conn, ph = elems[cell_type]
    cells = np.asarray(conn, np.int32)
    used = np.unique(cells)  # 0-based node ids
    remap = -np.ones(nnodes + 1, np.int64)
    remap[used] = np.arange(len(used))
    pts = coords[used + 1]  # coords table is 1-based (gmsh node tags)
    gdim = 2 if cell_type in ("triangle", "quadrilateral") else 3
    mesh = Mesh(pts[:, :gdim].copy(), remap[cells].astype(np.int32), cell_type)
    cell_tags = meshtags(mesh, mesh.tdim, np.arange(mesh.num_cells), np.asarray(ph, np.int32))

    facet_tags = None
    fname = _FACET_OF[cell_type]
    if fname in elems:
        fconn, fph = elems[fname]
        fverts_sorted = np.sort(remap[np.asarray(fconn, np.int64)], axis=1)
        mesh_fverts, _, _ = mesh.entities(mesh.tdim - 1)
        lookup = {tuple(row): j for j, row in enumerate(np.sort(mesh_fverts, axis=1).tolist())}
        idx, vals = [], []
        for row, p in zip(fverts_sorted.tolist(), fph):
            j = lookup.get(tuple(row))
            if j is not None:
                idx.append(j)
                vals.append(p)
        facet_tags = meshtags(mesh, mesh.tdim - 1, np.asarray(idx, np.int32),
                              np.asarray(vals, np.int32))
    return mesh, cell_tags, facet_tags


def write_gmsh(path: str, mesh: Mesh, cell_tags=None, facet_tags=None):
    """Write a Gmsh 4.1 ASCII .msh file (inverse of read_gmsh; the mesh
    export role of the reference's create_and_export_mesh.py).

    cell_tags/facet_tags: MeshTags — entities are grouped per physical tag
    (one gmsh entity per tag, carrying that physical id).  Untagged cells go
    to physical 0."""
    _CELL_GMSH = {name: code for code, (name, _) in _GMSH_CELL.items()}
    tdim = mesh.tdim
    pts = mesh.points
    n = pts.shape[0]
    xyz = np.zeros((n, 3))
    xyz[:, : pts.shape[1]] = pts

    cvals = np.zeros(mesh.num_cells, np.int64)
    if cell_tags is not None:
        cvals[np.asarray(cell_tags.indices, np.int64)] = np.asarray(cell_tags.values, np.int64)
    cgroups = [(int(t), np.flatnonzero(cvals == t)) for t in np.unique(cvals)]

    fgroups = []
    if facet_tags is not None:
        fverts, _, _ = mesh.entities(tdim - 1)
        fidx = np.asarray(facet_tags.indices, np.int64)
        fv = np.asarray(facet_tags.values, np.int64)
        for t in np.unique(fv):
            fgroups.append((int(t), fverts[fidx[fv == t]]))

    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Entities"]
    counts = [0, 0, 0, 0]
    counts[tdim] = len(cgroups)
    counts[tdim - 1] = len(fgroups)
    lines.append(" ".join(map(str, counts)))
    lo = xyz.min(axis=0)
    hi = xyz.max(axis=0)
    box = f"{lo[0]} {lo[1]} {lo[2]} {hi[0]} {hi[1]} {hi[2]}"
    ftag0 = 1
    for k, (t, _) in enumerate(fgroups):
        lines.append(f"{ftag0 + k} {box} 1 {t} 0")
    ctag0 = 1
    for k, (t, _) in enumerate(cgroups):
        lines.append(f"{ctag0 + k} {box} 1 {t} 0")
    lines.append("$EndEntities")

    lines += ["$Nodes", f"1 {n} 1 {n}",
              f"{tdim} {ctag0} 0 {n}"]
    lines += [str(i + 1) for i in range(n)]
    lines += [f"{xyz[i, 0]} {xyz[i, 1]} {xyz[i, 2]}" for i in range(n)]
    lines.append("$EndNodes")

    nblocks = len(fgroups) + len(cgroups)
    nelems = sum(len(g[1]) for g in fgroups) + sum(len(g[1]) for g in cgroups)
    lines += ["$Elements", f"{nblocks} {nelems} 1 {nelems}"]
    etag = 1
    fname = _FACET_OF[mesh.cell_type]
    for k, (t, conn) in enumerate(fgroups):
        lines.append(f"{tdim - 1} {ftag0 + k} {_CELL_GMSH[fname]} {len(conn)}")
        for row in np.asarray(conn, np.int64) + 1:
            lines.append(str(etag) + " " + " ".join(map(str, row)))
            etag += 1
    for k, (t, ids) in enumerate(cgroups):
        lines.append(f"{tdim} {ctag0 + k} {_CELL_GMSH[mesh.cell_type]} {len(ids)}")
        for row in mesh.cells[ids].astype(np.int64) + 1:
            lines.append(str(etag) + " " + " ".join(map(str, row)))
            etag += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
