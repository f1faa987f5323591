"""Mesh factories + Gmsh export shared by the disconnect demos.

Counterpart of ``demos/create_and_export_mesh.py``: structured meshes built
with the port's generators, bodies and surfaces tagged, exported as Gmsh 4.1
files with ``dolfinx_mpc_tpu_torch.io.write_gmsh``; the disconnect demos
load them back through ``read_gmsh``.  ``python -m
dolfinx_mpc_tpu_torch.demos.create_and_export_mesh`` writes them to
``dolfinx_mpc_tpu_torch/demos/meshes/`` (git-ignored, made on demand).
"""

import os

import numpy as np

MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "meshes")


def disconnected_plates_2d(nl=8, nu=6, gap=0.25):
    """Two disconnected rectangles: lower [0,1]x[0,1] (body tag 1) and upper
    [0,1]x[1+gap, 2+gap] (body tag 2); facet tags: 1 = lower bottom edge,
    2 = lower top edge, 3 = upper bottom edge."""
    from ..fem.mesh import Mesh, create_rectangle, meshtags

    lo = create_rectangle((0.0, 0.0), (1.0, 1.0), (nl, nl))
    hi = create_rectangle((0.0, 1.0 + gap), (1.0, 2.0 + gap), (nu, nu))
    pts = np.vstack([lo.points, hi.points])
    cells = np.vstack([lo.cells, hi.cells + lo.num_points])
    mesh = Mesh(pts, cells, lo.cell_type)
    cvals = np.ones(mesh.num_cells, np.int32)
    cvals[lo.num_cells :] = 2
    ct = meshtags(mesh, 2, np.arange(mesh.num_cells), cvals)

    fverts, _, _ = mesh.facets()
    fy = mesh.points[fverts][:, :, 1]
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    idx, vals = [], []
    for tag, y in ((1, 0.0), (2, 1.0), (3, 1.0 + gap)):
        sel = np.flatnonzero(np.isclose(fy, y).all(axis=1) & ext)
        idx.append(sel)
        vals.append(np.full(len(sel), tag, np.int32))
    ft = meshtags(mesh, 1, np.concatenate(idx), np.concatenate(vals))
    return mesh, ct, ft


def disconnected_boxes_3d(nl=4, nu=3, gap=0.25):
    """3D variant: lower unit cube (tag 1), upper cube above a gap (tag 2);
    facet tags: 1 = lower bottom face, 2 = lower top, 3 = upper bottom."""
    from ..fem.mesh import Mesh, create_box, meshtags

    lo = create_box((0, 0, 0), (1, 1, 1), (nl, nl, nl))
    hi = create_box((0, 0, 1 + gap), (1, 1, 2 + gap), (nu, nu, nu))
    pts = np.vstack([lo.points, hi.points])
    cells = np.vstack([lo.cells, hi.cells + lo.num_points])
    mesh = Mesh(pts, cells, lo.cell_type)
    cvals = np.ones(mesh.num_cells, np.int32)
    cvals[lo.num_cells :] = 2
    ct = meshtags(mesh, 3, np.arange(mesh.num_cells), cvals)

    fverts, _, _ = mesh.facets()
    fz = mesh.points[fverts][:, :, 2]
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    idx, vals = [], []
    for tag, z in ((1, 0.0), (2, 1.0), (3, 1.0 + gap)):
        sel = np.flatnonzero(np.isclose(fz, z).all(axis=1) & ext)
        idx.append(sel)
        vals.append(np.full(len(sel), tag, np.int32))
    ft = meshtags(mesh, 2, np.concatenate(idx), np.concatenate(vals))
    return mesh, ct, ft


def mesh_path(name: str) -> str:
    """Path of a fixture in MESH_DIR, written first if it is missing."""
    path = os.path.join(MESH_DIR, name)
    if not os.path.exists(path):
        export_all()
    return path


def export_all(out_dir=MESH_DIR):
    from ..io import write_gmsh

    os.makedirs(out_dir, exist_ok=True)
    mesh, ct, ft = disconnected_plates_2d()
    write_gmsh(os.path.join(out_dir, "disconnect_2d.msh"), mesh, ct, ft)
    mesh, ct, ft = disconnected_boxes_3d()
    write_gmsh(os.path.join(out_dir, "disconnect_3d.msh"), mesh, ct, ft)
    print(f"wrote fixtures to {out_dir}")


if __name__ == "__main__":
    export_all()
