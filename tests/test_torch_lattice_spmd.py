"""The port's sharded lattice path (dolfinx_mpc_tpu_torch/parallel/
lattice_spmd.py) on spawned gloo ranks on the CPU against the JAX
package's ShardedLatticeProblem on 8 virtual CPU devices, Jacobi and
Chebyshev: the non-GMG, non-slow cases of tests/test_lattice_spmd.py (1, 4
and 8 ranks, uneven slabs, Chebyshev, the multi-term coefficient form, 2-D
rank grids (4, 2), (2, 4), (2, 2), uneven boxes, 2-D Chebyshev) and a bs=3
elasticity case: solutions to 1e-9, float64 CG counts within 1 of the JAX
package's.  The GMG cases are tests/test_torch_lattice_spmd_gmg.py's; the
million-dof case stays slow, as in the JAX file.  One spawned group per
rank count serves every case."""

import numpy as np
import pytest

import torch_spmd_cases as cases
from dolfinx_mpc_tpu_torch.parallel import run_ranks
from torch_lattice_spmd_jax import jax_case, jx_cube

RANKS = (1, 4, 8)


@pytest.fixture(scope="module")
def port_runs():
    return {n: run_ranks(cases.lattice_rank, n, backend="gloo", device="cpu", args=("basic",)) for n in RANKS}


# (case, rank counts it runs at)
CASES = [("match6", (1, 4, 8)), ("uneven5", (4,)), ("boxes(2, 2)", (4,)), ("boxes(4, 2)", (8,)), ("boxes(2, 4)", (8,)),
         ("uneven_boxes7", (8,)), ("boxes_cheb8", (8,)), ("coefficient6", (8,)), ("jacobi32", (8,)), ("cheb32", (8,)),
         ("vector8", (8,))]


@pytest.mark.parametrize("name,n_dev", [(c, n) for c, ns in CASES for n in ns])
def test_matches_jax(port_runs, name, n_dev):
    """Each rank's solution equals the JAX sharded solve of the same case
    to 1e-9, in the JAX package's CG count (within 1: the all-reduce order
    of the dot products differs)."""
    uj, itsj, _ = jax_case(name, n_dev)
    for r in port_runs[n_dev]:
        got = r[name]
        assert np.abs(got["u"] - uj).max() < 1e-9, name
        assert abs(got["its"] - itsj) <= 1, (got["its"], itsj)


@pytest.mark.parametrize("n_dev", RANKS)
def test_matches_single_device(port_runs, n_dev):
    """tests/test_lattice_spmd.py::test_sharded_lattice_matches_single: the
    port's sharded solve equals the port's and the JAX package's
    single-device LinearProblem to 1e-9."""
    import dolfinx_mpc_tpu as jdmt
    import dolfinx_mpc_tpu_torch as pt

    V, a, L, mpc, bc = cases.periodic_cube(6, 0.5, 1)
    ref = pt.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-12}).solve().x.array.numpy()
    Vj, aj, Lj, mpcj, bcj = jx_cube(6)
    refj = np.asarray(jdmt.LinearProblem(aj, Lj, mpcj, bcs=[bcj], petsc_options={"ksp_rtol": 1e-12}).solve().x.array)
    u = port_runs[n_dev][0]["match6"]["u"]
    assert np.abs(u - ref).max() < 1e-9 and np.abs(u - refj).max() < 1e-9


def test_chebyshev_cuts_iterations(port_runs):
    """At n=32 on 8 ranks Chebyshev-Jacobi needs fewer CG iterations than
    Jacobi for the same solution (tests/test_lattice_spmd.py's n=32 case)."""
    r = port_runs[8][0]
    assert r["cheb32"]["its"] < r["jacobi32"]["its"]
    assert np.abs(r["cheb32"]["u"] - r["jacobi32"]["u"]).max() < 1e-7
