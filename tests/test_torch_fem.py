"""The port's host substrate (meshes, spaces, quadrature, elements, bcs and
the finalized periodic MPC) is EXACTLY equal to the JAX package's."""

import numpy as np
import pytest

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem.elements import lagrange_element as jx_element
from dolfinx_mpc_tpu.fem.mesh import create_box as jx_box
from dolfinx_mpc_tpu.fem.quadrature import quadrature_rule as jx_rule
from dolfinx_mpc_tpu_torch.fem.elements import lagrange_element as pt_element
from dolfinx_mpc_tpu_torch.fem.mesh import create_box as pt_box
from dolfinx_mpc_tpu_torch.fem.quadrature import quadrature_rule as pt_rule

DIMS = [(4, 4, 4), (3, 4, 5)]


def _new_mpc(pkg, V, dtype):
    """pkg.MultiPointConstraint(V, dtype), on the CPU for the port (its
    entry points default to the card)."""
    return pkg.MultiPointConstraint(V, dtype, **({"device": "cpu"} if pkg is pt else {}))


def _periodic(pkg, box, dims, degree=1):
    mesh = box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), dims)
    V = pkg.functionspace(mesh, ("Lagrange", degree))
    bdofs = pkg.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0))
    bc = pkg.dirichletbc(0.0, bdofs, V)
    mpc = _new_mpc(pkg, V, np.float64)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0),
        lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    return mesh, V, bc, mpc


@pytest.mark.parametrize("dims", DIMS)
@pytest.mark.parametrize("degree", [1, 2])
def test_mesh_space_bc_mpc_equal(dims, degree):
    mj, Vj, bcj, mpcj = _periodic(jx, jx_box, dims, degree)
    mp, Vp, bcp, mpcp = _periodic(pt, pt_box, dims, degree)
    assert np.array_equal(mj.points, mp.points)
    assert np.array_equal(mj.cells, mp.cells)
    assert Vj.num_dofs == Vp.num_dofs
    assert np.array_equal(Vj.dofmap, Vp.dofmap)
    assert np.array_equal(Vj.dof_coords_blocks, Vp.dof_coords_blocks)
    assert np.array_equal(bcj.dofs, bcp.dofs)
    assert np.array_equal(mpcj.slaves, mpcp.slaves)
    assert np.array_equal(mpcj._np_masters, mpcp._np_masters)
    assert np.array_equal(mpcj._np_coeffs, mpcp._np_coeffs)
    assert np.array_equal(mpcj.is_slave, mpcp.is_slave)
    fin = mpcp.finalized
    assert np.array_equal(fin.slaves.numpy(), mpcj.slaves)
    assert np.array_equal(fin.masters.numpy(), mpcj._np_masters)
    assert np.array_equal(fin.coeffs.numpy(), mpcj._np_coeffs)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_quadrature_and_tabulation_equal(degree):
    from dolfinx_mpc_tpu.fem.cells import get_cell as jx_cell
    from dolfinx_mpc_tpu_torch.fem.cells import get_cell as pt_cell

    qj, wj = jx_rule(jx_cell("tetrahedron"), degree)
    qp, wp = pt_rule(pt_cell("tetrahedron"), degree)
    assert np.array_equal(qj, qp) and np.array_equal(wj, wp)
    for el_deg in (1, 2):
        ej, ep = jx_element("tetrahedron", el_deg), pt_element("tetrahedron", el_deg)
        assert np.array_equal(ej.nodes, ep.nodes)
        assert np.array_equal(ej.tabulate(qj), ep.tabulate(qp))
        assert np.array_equal(ej.tabulate_grad(qj), ep.tabulate_grad(qp))


def test_backsubstitution_homogenize_reduce_transpose():
    """FinalizedMPC's gather-FMA kernels equal the JAX package's on the same
    tables and vector (float64)."""
    import jax.numpy as jnp
    import torch

    from dolfinx_mpc_tpu_torch.utils.interop import finalized_mpc_from_numpy

    _, Vj, _, mpcj = _periodic(jx, jx_box, (3, 4, 5))
    fj = mpcj.finalized
    fp = finalized_mpc_from_numpy(np.asarray(fj.slaves), np.asarray(fj.masters),
                                  np.asarray(fj.coeffs), np.asarray(fj.is_slave), fj.num_dofs,
                                  device="cpu")
    u = np.random.default_rng(0).standard_normal(Vj.num_dofs)
    ut = torch.as_tensor(u)
    for name in ("backsubstitution", "homogenize", "reduce_transpose"):
        ref = np.asarray(getattr(fj, name)(jnp.asarray(u)))
        got = getattr(fp, name)(ut).numpy()
        assert np.array_equal(ref, got), name


def test_entry_points_default_to_the_card():
    """Entry points place their tensors on the card unless the caller asks
    for the CPU: without a card, MultiPointConstraint(V) (no device) raises
    RuntimeError instead of quietly running on the CPU; with one it lands
    on cuda.  device="cpu" works either way."""
    import torch

    V = pt.functionspace(pt_box((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (2, 2, 2)), ("Lagrange", 1))
    assert pt.MultiPointConstraint(V, device="cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert pt.MultiPointConstraint(V).device.type == "cuda"
        assert pt.Function(V).x.array.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.MultiPointConstraint(V)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.Function(V)
