"""The port's native setup kernels (dolfinx_mpc_tpu_torch/native, built
from the shared csrc/native.cpp) against the JAX package's native module
and numpy: tests/test_native.py's sort_unique_inverse and point location,
the restricted-cell locator included."""

import numpy as np
import pytest

import dolfinx_mpc_tpu.fem.mesh as jx_mesh
import dolfinx_mpc_tpu_torch.fem.mesh as pt_mesh
from dolfinx_mpc_tpu import native as jx_native
from dolfinx_mpc_tpu.fem.geometry_maps import PointLocator as JLocator
from dolfinx_mpc_tpu_torch import native as pt_native
from dolfinx_mpc_tpu_torch.fem.elements import lagrange_element
from dolfinx_mpc_tpu_torch.fem.geometry_maps import PointLocator, _tabulate_rows


def test_native_builds():
    assert pt_native.available(), "the port's native library failed to build"
    assert jx_native.available()


def test_sort_unique_inverse_matches_jax_and_numpy():
    keys = np.random.default_rng(7).integers(0, 10_000, size=100_000).astype(np.int64)
    u1, f1, i1 = pt_native.sort_unique_inverse(keys)
    uj, fj, ij = jx_native.sort_unique_inverse(keys)
    u2, _, i2 = np.unique(keys, return_index=True, return_inverse=True)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(keys[f1], u1)  # each first index points at its key
    for a, b in ((u1, uj), (f1, fj), (i1, ij)):
        np.testing.assert_array_equal(a, b)


MESHERS = {
    "triangle": lambda m: m.create_unit_square(5, 5),
    "quadrilateral": lambda m: m.create_unit_square(4, 4, "quadrilateral"),
    "tetrahedron": lambda m: m.create_unit_cube(3, 3, 3),
    "hexahedron": lambda m: m.create_unit_cube(3, 3, 3, "hexahedron"),
}


@pytest.mark.parametrize("cell_type", list(MESHERS))
def test_locate_points_matches_jax(cell_type):
    """The port's locator finds the JAX package's cells and reference
    points, and its geometry map reproduces every query point."""
    mesh = MESHERS[cell_type](pt_mesh)
    mesh_j = MESHERS[cell_type](jx_mesh)
    pts = np.random.default_rng(3).random((50, mesh.gdim)) * 0.999 + 5e-4
    cells, X = PointLocator(mesh).locate(pts)
    cells_j, X_j = JLocator(mesh_j).locate(pts)
    assert (cells >= 0).all()
    np.testing.assert_array_equal(cells, cells_j)
    assert np.abs(X - X_j).max() < 1e-12
    phi = _tabulate_rows(lagrange_element(cell_type, 1), X)  # (n, nv)
    back = np.einsum("nv,nvg->ng", phi, mesh.points[mesh.cells[cells]])
    assert np.abs(back - pts).max() < 1e-9
    # the same through the native entry point directly
    got = pt_native.locate_points(pts, mesh.cells, mesh.points, mesh.cell_type)
    want = jx_native.locate_points(pts, mesh_j.cells, mesh_j.points, mesh_j.cell_type)
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() < 1e-12


def test_locate_points_restricted_cells():
    mesh = pt_mesh.create_unit_square(4, 4)
    left = np.flatnonzero(mesh.points[mesh.cells].mean(axis=1)[:, 0] < 0.5)
    q = np.array([[0.1, 0.5], [0.9, 0.5]])
    cells, _ = PointLocator(mesh, left).locate(q)
    cells_j, _ = JLocator(jx_mesh.create_unit_square(4, 4), left).locate(q)
    assert cells[0] in left and cells[1] == -1  # outside the restricted set
    np.testing.assert_array_equal(cells, cells_j)
