"""Parity of the port's last two MultiPointConstraint methods with the JAX
package: MultiPointConstraint.cell_to_slaves (per cell, the positions of
its slave dofs in the slave list; the reference's MultiPointConstraint.h:66)
and FinalizedMPC.expand (u = K û, an alias of backsubstitution).

cell_to_slaves is host numpy code, so the lists must be equal array by
array; expand is one gather-FMA in float64, held to 1e-14 relative.  The
constraints: the periodic P1 cube of the JAX dry run's problem at n=6, the
tied-contact MPC of tests/test_torch_contact.py at its smallest size
(NB=4/NT=3) and a constraint with no slaves.
"""

import functools
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import mesh as jm
from dolfinx_mpc_tpu_torch.fem import mesh as pm
from dolfinx_mpc_tpu_torch.parallel.dryrun import build_problem

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from __graft_entry__ import _build_problem  # noqa: E402

CASES = ("periodic-cube-n6", "contact-4-3", "no-slaves")


def _contact(mod, M, kw, nb=4, nt=3):
    """The tied-contact MPC of two stacked P1 vector boxes (finalized)."""
    bot = M.create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = M.create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = M.Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                  bot.cell_type)
    V = mod.functionspace(mesh, ("Lagrange", 1, (3,)))
    fverts, _, f2c = mesh.facets()
    on_iface = np.isclose(mesh.points[fverts][:, :, 2], 1.0).all(axis=1)
    iface = np.flatnonzero(on_iface & np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets()))
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    mpc = mod.MultiPointConstraint(V, np.float64, **kw)
    mpc.create_contact_inelastic_condition(M.meshtags(mesh, 2, iface, np.where(cz > 1.0, 1, 2)), 1, 2)
    mpc.finalize()
    return mpc


def _empty(mod, M, kw):
    mpc = mod.MultiPointConstraint(mod.functionspace(M.create_unit_square(3, 3), ("Lagrange", 1)), **kw)
    mpc.finalize()
    return mpc


@functools.lru_cache(maxsize=None)
def _pair(case):
    """(JAX MPC, port MPC on the CPU), both finalized."""
    if case == "periodic-cube-n6":
        return _build_problem(n=6, cube=True)[4], build_problem(6, cube=True, device="cpu")[3]
    build = _contact if case == "contact-4-3" else _empty
    return build(jx, jm, {}), build(pt, pm, {"device": "cpu"})


@pytest.mark.parametrize("case", CASES)
def test_cell_to_slaves_equal_jax(case):
    mj, mp = _pair(case)
    want, got = mj.cell_to_slaves(), mp.cell_to_slaves()
    assert len(got) == len(want) == mp.V.dofmap.shape[0]
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)
    assert sum(len(g) for g in got) > 0 or case == "no-slaves"


@pytest.mark.parametrize("case", CASES)
def test_expand_equals_backsubstitution_and_jax(case):
    mj, mp = _pair(case)
    u = np.random.default_rng(16).standard_normal(mp.V.num_dofs)
    ut = torch.as_tensor(u.copy())
    got = mp.finalized.expand(ut)
    assert got is not ut or mp.num_local_slaves == 0
    np.testing.assert_array_equal(got.numpy(), mp.finalized.backsubstitution(ut).numpy())
    np.testing.assert_array_equal(ut.numpy(), u)  # expand left its input as it was
    want = np.asarray(mj.finalized.expand(jnp.asarray(u)))
    assert np.linalg.norm(got.numpy() - want) <= 1e-14 * np.linalg.norm(want)


def test_cell_to_slaves_before_finalize_raises():
    for mod, M, kw in ((jx, jm, {}), (pt, pm, {"device": "cpu"})):
        mpc = mod.MultiPointConstraint(mod.functionspace(M.create_unit_square(2, 2), ("Lagrange", 1)), **kw)
        with pytest.raises(RuntimeError, match="finalize"):
            mpc.cell_to_slaves()
