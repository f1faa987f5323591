"""Parity of the port's gmsh and XDMF I/O (io.py) with the JAX package:
write_gmsh from both packages gives byte-equal files, read_gmsh of the
checked-in demo meshes (demos/meshes/*.msh) and of a hand-written Gmsh 4.1
file gives equal arrays, and the XDMF writer round-trips through h5py
(skipped where h5py is not installed).  The mesh-export factories of the
port's demos equal the JAX demos' ones array for array."""

import glob
import os

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu import io as jio
from dolfinx_mpc_tpu.fem import mesh as jm
from dolfinx_mpc_tpu_torch import io as pio
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DEMO_MESHES = sorted(glob.glob(os.path.join(ROOT, "demos", "meshes", "*.msh")))

# tests/test_io.py's square: 4 triangles, cell tag 10, edges tagged 5 and 6
GMSH_SQUARE = """$MeshFormat
4.1 0 8
$EndMeshFormat
$Entities
4 4 1 0
1 0 0 0 0
2 1 0 0 0
3 1 1 0 0
4 0 1 0 0
1 0 0 0 1 0 0 1 5 2 1 -2
2 1 0 0 1 1 0 1 6 2 2 -3
3 0 1 0 1 1 0 0 2 3 -4
4 0 0 0 0 1 0 0 2 4 -1
1 0 0 0 1 1 0 1 10 4 1 2 3 4
$EndEntities
$Nodes
5 5 1 5
0 1 0 1
1
0 0 0
0 2 0 1
2
1 0 0
0 3 0 1
3
1 1 0
0 4 0 1
4
0 1 0
2 1 0 1
5
0.5 0.5 0
$EndNodes
$Elements
3 8 1 8
1 1 1 2
1 1 2
2 2 3
1 2 1 2
3 2 3
4 3 4
2 1 2 4
5 1 2 5
6 2 3 5
7 3 4 5
8 4 1 5
$EndElements
"""


def _tags(t):
    return None if t is None else (t.dim, np.asarray(t.indices), np.asarray(t.values))


def _assert_read_equal(path):
    mj, cj, fj = jio.read_gmsh(path)
    mp, cp, fp = pio.read_gmsh(path)
    assert mp.cell_type == mj.cell_type
    assert np.array_equal(mp.points, mj.points) and np.array_equal(mp.cells, mj.cells)
    for g, r in ((cp, cj), (fp, fj)):
        g, r = _tags(g), _tags(r)
        assert (g is None) == (r is None)
        if g is not None:
            assert g[0] == r[0] and all(np.array_equal(a, b) for a, b in zip(g[1:], r[1:]))
    return mp, cp, fp


@pytest.mark.parametrize("path", DEMO_MESHES, ids=[os.path.basename(p) for p in DEMO_MESHES])
def test_read_gmsh_demo_meshes_equal_jax(path):
    mesh, ct, ft = _assert_read_equal(path)
    assert mesh.num_cells > 0 and ft is not None


def test_read_gmsh_square_equal_jax(tmp_path):
    """tests/test_io.py::test_gmsh_reader's file through both readers, and
    the mesh assembles on the port."""
    p = str(tmp_path / "m.msh")
    with open(p, "w") as f:
        f.write(GMSH_SQUARE)
    mesh, ct, ft = _assert_read_equal(p)
    assert (mesh.cell_type, mesh.num_cells, mesh.num_points) == ("triangle", 4, 5)
    assert (ct.values == 10).all() and set(ft.values.tolist()) == {5, 6} and len(ft.indices) == 4
    V = pt.functionspace(mesh, ("Lagrange", 1))
    a = pt.BilinearForm(V, lambda u, v, c: pf.inner(pf.grad(u), pf.grad(v)) + pf.inner(u, v))
    assert bool(torch.isfinite(pt.assemble_matrix(a, None, device="cpu").data).all())


@pytest.mark.parametrize("cell,tagged", [("triangle", True), ("quadrilateral", False), ("tetrahedron", True),
                                         ("hexahedron", True)])
def test_write_gmsh_byte_equal_jax(tmp_path, cell, tagged):
    """Both writers on the same mesh and tags (values from a seed) give the
    same bytes, and the file reads back to the same arrays."""
    files = []
    for name, M, io in (("jx", jm, jio), ("pt", pm, pio)):
        mesh = (M.create_unit_cube(2, 2, 2, cell) if cell in ("tetrahedron", "hexahedron")
                else M.create_unit_square(3, 3, cell))
        rng = np.random.default_rng(5)
        ct = ft = None
        if tagged:
            ct = M.meshtags(mesh, mesh.tdim, np.arange(mesh.num_cells), rng.integers(1, 4, mesh.num_cells))
            ext = mesh.exterior_facets()
            ft = M.meshtags(mesh, mesh.tdim - 1, ext, rng.integers(1, 3, len(ext)))
        p = tmp_path / f"{name}.msh"
        io.write_gmsh(str(p), mesh, ct, ft)
        files.append(p.read_bytes())
    assert files[0] == files[1]
    _assert_read_equal(str(tmp_path / "pt.msh"))


def test_demo_mesh_factories_equal_jax(tmp_path):
    """The port's create_and_export_mesh builds the JAX demo's meshes and
    writes byte-equal files."""
    import sys

    sys.path.insert(0, ROOT)
    from demos import create_and_export_mesh as jdemo
    from dolfinx_mpc_tpu_torch.demos import create_and_export_mesh as pdemo

    for name in ("disconnected_plates_2d", "disconnected_boxes_3d"):
        (mj, cj, fj), (mp, cp, fp) = getattr(jdemo, name)(3, 2), getattr(pdemo, name)(3, 2)
        assert np.array_equal(mp.points, mj.points) and np.array_equal(mp.cells, mj.cells)
        jio.write_gmsh(str(tmp_path / "j.msh"), mj, cj, fj)
        pio.write_gmsh(str(tmp_path / "p.msh"), mp, cp, fp)
        assert (tmp_path / "j.msh").read_bytes() == (tmp_path / "p.msh").read_bytes()
    pdemo.export_all(str(tmp_path / "meshes"))
    assert sorted(os.listdir(tmp_path / "meshes")) == ["disconnect_2d.msh", "disconnect_3d.msh"]


def test_xdmf_round_trip_equal_jax(tmp_path):
    """tests/test_io.py::test_xdmf_write through the port: the .h5 holds the
    mesh and the function's values, the .xdmf parses, and both files equal
    the JAX package's."""
    h5py = pytest.importorskip("h5py")
    import xml.etree.ElementTree as ET

    out = {}
    for name, mod, M, io in (("jx", jx, jm, jio), ("pt", pt, pm, pio)):
        mesh = M.create_unit_square(3, 3)
        V = mod.functionspace(mesh, ("Lagrange", 1, (2,)))
        u = mod.Function(V, name="u", **({"device": "cpu"} if name == "pt" else {}))
        u.interpolate(lambda x: np.stack([x[0] + x[1], x[0] * x[1]]))
        d = tmp_path / name
        d.mkdir()
        with io.XDMFFile(str(d / "out.xdmf")) as f:
            f.write_mesh(mesh)
            f.write_function(u)
        ET.parse(str(d / "out.xdmf"))
        with h5py.File(str(d / "out.h5")) as h5:
            out[name] = ((d / "out.xdmf").read_text(), {k: np.asarray(h5[k]) for k in
                                                        ("mesh/points", "mesh/cells", "func/u")})
        if name == "pt":
            assert out[name][1]["mesh/points"].shape == (mesh.num_points, 3)
            assert np.array_equal(out[name][1]["func/u"].ravel(), u.x.array.numpy())
    assert out["pt"][0] == out["jx"][0]
    for k, v in out["jx"][1].items():
        assert np.array_equal(out["pt"][1][k], v)
