"""The port's demos (dolfinx_mpc_tpu_torch/demos) at tests/test_demos.py's CI
sizes on the CPU: each runs its own checks (its oracle, compare_mpc_lhs,
periodicity, energy drift, interface continuity, eigenvalues against scipy,
slip), and its returned solution equals the JAX demo's (demos/) on the same
input to 1e-10 (the nest Stokes demo, whose BiCGStab stops at rtol 1e-10,
field by field relative to the field's largest value).  The disconnect
demos read one gmsh file, written by the JAX demos' factory."""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def _array(u):
    if isinstance(u, tuple):
        return np.concatenate([_array(x) for x in u])
    if hasattr(u, "x"):
        u = u.x.array
    return u.numpy() if isinstance(u, torch.Tensor) else np.asarray(u)


def _both(name, **kw):
    """(port solution, JAX solution) of demo `name` with the same arguments."""
    port = importlib.import_module(f"dolfinx_mpc_tpu_torch.demos.{name}").main(device="cpu", **kw)
    if hasattr(port, "x"):
        assert port.x.array.device.type == "cpu"
    ref = importlib.import_module(f"demos.{name}").main(**kw)
    return _array(port), _array(ref)


@pytest.mark.parametrize("name,kw", [
    ("demo_periodic_geometrical", dict(n=12)),
    ("demo_periodic3d_topological", dict(n=4, degree=2)),
    ("demo_elasticity", dict(n=8)),
    ("demo_contact_2D", dict(nb=5, nt=4)),
    ("demo_contact_3D", dict(nb=3, nt=2)),
    ("demo_linear_wave_problem", dict(n=12, steps=10)),
])
def test_demo_matches_jax(name, kw):
    got, ref = _both(name, **kw)
    assert got.shape == ref.shape and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-10


@pytest.mark.parametrize("name,kw,counts", [
    ("demo_periodic_gep", dict(n=8, nev=3), ("outer", "inner")),
    ("demo_stokes", dict(nx=8, ny=4), ("its",)),
    ("demo_stokes_nonlinear_nest", dict(nx=6, ny=3), ("its",)),
])
def test_solver_demo_matches_jax(name, kw, counts):
    """The eigen, mixed-space GMRES and nonlinear nest demos: their
    solutions (eigenvalues) to 1e-10 and their solver counts, which the JAX
    demos print, recorded through info=."""
    info = {}
    port = importlib.import_module(f"dolfinx_mpc_tpu_torch.demos.{name}").main(device="cpu", info=info, **kw)
    ref = importlib.import_module(f"demos.{name}").main(**kw)
    got, want = _array(port), _array(ref)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-10
    assert all(info[k] > 0 for k in counts)


def test_stokes_nest_demo_matches_jax():
    """The nest Stokes demo with the JAX demo's own Chebyshev probe
    (jax.random.normal(PRNGKey(0), ...) as numpy): velocity and pressure
    each to 1e-10 of their largest value (both solves stop at rtol 1e-10),
    on CSR blocks; on BELL blocks (to_bell: another summation order, so
    another BiCGStab count) the velocity to 1e-8 of its largest value."""
    import jax
    import jax.numpy as jnp

    from demos.demo_stokes_nest import main as jx_main
    from dolfinx_mpc_tpu_torch.demos.demo_stokes_nest import main as pt_main

    nV = 2 * (2 * 8 + 1) * (2 * 4 + 1)  # P2 vector dofs on the 8 x 4 rectangle
    probe = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (nV,), dtype=jnp.float64))
    u_ref, p_ref = (np.asarray(a) for a in jx_main(nx=8, ny=4))
    info = {}
    u, p = pt_main(nx=8, ny=4, probe=probe, device="cpu", info=info)
    assert u.shape == u_ref.shape and p.shape == p_ref.shape and info["its"] > 1
    for got, ref in ((u, u_ref), (p, p_ref)):
        assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    from dolfinx_mpc_tpu_torch.demos.demo_stokes_nest import preconditioner, problem
    from dolfinx_mpc_tpu_torch.la.solvers import bicgstab

    pb = problem(8, 4, device="cpu")
    A = pb.A.to_bell()
    x, _, _ = bicgstab(A.matvec, pb.rhs, M=preconditioner(A, pb.mass_q, probe), rtol=1e-10, max_it=4000)
    u_b = pb.mpc.finalized.backsubstitution(x[: pb.V.num_dofs]).numpy()
    assert np.abs(u_b - u_ref).max() <= 1e-8 * np.abs(u_ref).max()


@pytest.mark.parametrize("name,factory,args", [
    ("demo_elasticity_disconnect_2D", "disconnected_plates_2d", (5, 4)),
    ("demo_elasticity_disconnect", "disconnected_boxes_3d", (3, 2)),
])
def test_disconnect_demo_matches_jax(tmp_path, name, factory, args):
    from demos import create_and_export_mesh as jdemo

    from dolfinx_mpc_tpu.io import write_gmsh

    p = str(tmp_path / "d.msh")
    write_gmsh(p, *getattr(jdemo, factory)(*args))
    got, ref = _both(name, msh_path=p)
    assert np.abs(got - ref).max() <= 1e-10


def test_create_and_export_roundtrip(tmp_path):
    """tests/test_demos.py's round trip through the port's factory, writer
    and reader."""
    from dolfinx_mpc_tpu_torch.demos.create_and_export_mesh import disconnected_plates_2d
    from dolfinx_mpc_tpu_torch.io import read_gmsh, write_gmsh

    mesh, ct, ft = disconnected_plates_2d(nl=3, nu=2)
    p = tmp_path / "rt.msh"
    write_gmsh(str(p), mesh, ct, ft)
    m2, c2, f2 = read_gmsh(str(p))
    assert m2.num_cells == mesh.num_cells
    assert set(np.unique(c2.values).tolist()) == {1, 2}
    assert f2 is not None and set(np.unique(f2.values).tolist()) == {1, 2, 3}


def test_demo_meshes_made_on_demand(tmp_path, monkeypatch):
    """Without msh_path the disconnect demos read the port's own fixtures,
    written on first use into the (git-ignored) meshes folder."""
    from dolfinx_mpc_tpu_torch.demos import create_and_export_mesh as pdemo

    monkeypatch.setattr(pdemo, "MESH_DIR", str(tmp_path / "meshes"))
    monkeypatch.setattr(pdemo.export_all, "__defaults__", (str(tmp_path / "meshes"),))
    path = pdemo.mesh_path("disconnect_2d.msh")
    assert path.startswith(str(tmp_path)) and os.path.exists(path)
