"""The port's sharded lattice path with its GMG preconditioners on spawned
gloo ranks on the CPU against the JAX package's ShardedLatticeProblem on 8
virtual CPU devices: the GMG cases of tests/test_lattice_spmd.py (two-level
GMG at 1, 4 and 8 ranks, three-level GMG, memory_report), solutions to
1e-9 and float64 CG counts within 1 of the JAX package's; and a complex128
Bloch phase at sharded_levels=2 against the K (K^H A K)^-1 K^H b oracle to
1e-10, the middle level keeping its complex diagval (the JAX package keeps
its real part, parallel/lattice_spmd.py:485).  One spawned group per rank
count serves every case."""

import numpy as np
import pytest

import torch_spmd_cases as cases
from dolfinx_mpc_tpu_torch.parallel import run_ranks
from torch_lattice_spmd_jax import jax_case, jx_mesh

RANKS = (1, 4, 8)


@pytest.fixture(scope="module")
def port_runs():
    return {n: run_ranks(cases.lattice_rank, n, backend="gloo", device="cpu", args=("gmg",)) for n in RANKS}


@pytest.mark.parametrize("name,n_dev", [("gmg8", 1), ("gmg8", 4), ("gmg32", 8), ("levels1", 8), ("levels2", 8)])
def test_matches_jax(port_runs, name, n_dev):
    """Each rank's solution equals the JAX sharded solve of the same case
    to 1e-9, in the JAX package's CG count (within 1)."""
    uj, itsj, _ = jax_case(name, n_dev)
    for r in port_runs[n_dev]:
        got = r[name]
        assert np.abs(got["u"] - uj).max() < 1e-9, name
        assert abs(got["its"] - itsj) <= 1, (got["its"], itsj)


def test_gmg_cuts_iterations(port_runs):
    """tests/test_lattice_spmd.py::test_sharded_gmg_two_level: at n=32 on 8
    ranks the two-level GMG takes at most 16 iterations, fewer than Jacobi."""
    r = port_runs[8][0]
    assert r["gmg32"]["its"] <= 16 and r["gmg32"]["its"] < r["jacobi32"]["its"]
    assert np.abs(r["gmg32"]["u"] - r["jacobi32"]["u"]).max() < 1e-7


def test_three_level_gmg(port_runs):
    """sharded_levels=2: the same V-cycle with the middle level sharded,
    within 2 iterations of the two-level scheme and a strictly smaller
    replicated footprint."""
    r = port_runs[8][0]
    assert np.abs(r["levels2"]["u"] - r["levels1"]["u"]).max() < 1e-8
    assert r["levels2"]["its"] <= r["levels1"]["its"] + 2
    assert r["levels2"]["memory"]["replicated_coarse"] < r["levels1"]["memory"]["replicated_coarse"]


def test_memory_report(port_runs):
    """tests/test_lattice_spmd.py::test_sharded_gmg_memory_report: the
    replicated hierarchy is counted, the per-rank share holds the stencil,
    and a Jacobi problem replicates nothing."""
    m = port_runs[8][0]["memory16"]
    assert m["gmg"]["n_devices"] == 8
    assert m["gmg"]["replicated_coarse"] > 0
    assert m["gmg"]["sharded_per_device"] >= m["gmg"]["stencil_data_per_device"] > 0
    assert m["jacobi"]["replicated_coarse"] == 0


def test_bloch_phase_three_levels_meets_the_oracle(port_runs):
    """complex128, a Bloch phase e^{i pi/3} in x on the fine level, a GMG of
    complex fold levels with diagval 1 + 0.5i at sharded_levels=2: the
    solution meets the oracle K (K^H A K)^-1 K^H b to 1e-10, and the
    sharded middle level keeps diagval 1 + 0.5i, where the JAX package's
    keeps 1.0 (lattice_spmd.py:485).  Its middle-level slave rows start at
    zero and see only masked residuals, so the JAX package's solution
    meets the oracle on this input too (ROADMAP queue 3)."""
    import scipy.sparse.linalg as spla

    import dolfinx_mpc_tpu_torch as pt
    from dolfinx_mpc_tpu_torch.utils.verification import gather_transformation_matrix

    V, a, L, mpc, bc = cases.bloch_problem(16)
    A = pt.assemble_matrix(a, None, bcs=[bc], dtype=np.complex128, device="cpu").to_scipy()
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, None, dtype=np.complex128, device="cpu"), [a], [[bc]], None,
                                   dtype=np.complex128, device="cpu"), [bc]).numpy()
    K = gather_transformation_matrix(mpc)
    KH = K.conj().T
    u_ref = K @ spla.spsolve((KH @ A @ K).tocsc(), KH @ b)
    for r in port_runs[8]:
        got = r["bloch16"]
        assert np.abs(got["u"] - u_ref).max() < 1e-10
        assert got["mid_diagval"] == cases.BLOCH_LEVEL_DIAGVAL


def _jax_bloch_problem(with_masks):
    """The Bloch case's input as the JAX package's ShardedLatticeProblem on
    8 devices at sharded_levels=2, its coarse LatticeGMG with or without
    the hierarchy's free masks."""
    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu.la.gmg import LatticeGMG, build_gmg_hierarchy
    from dolfinx_mpc_tpu.ops.lattice import assemble_matrix_lattice
    from dolfinx_mpc_tpu.parallel.lattice_spmd import ShardedLatticeProblem

    y_planes = lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)  # noqa: E731

    def problem(m, phase):
        V = dmt.functionspace(create_unit_cube(m, m, m), ("Lagrange", 1))
        bc = dmt.dirichletbc(0.5, dmt.locate_dofs_geometrical(V, y_planes), V)
        mpc = dmt.MultiPointConstraint(V, np.complex128)
        mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                                   lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc], scale=phase)
        mpc.finalize()
        return V, dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1), mpc, bc

    def level(m):
        _, al, mpcl, bcl = problem(m, 1.0)
        return assemble_matrix_lattice(al, mpcl, bcs=[bcl], diagval=cases.BLOCH_LEVEL_DIAGVAL, dtype=np.complex128,
                                       side_format="fold")

    V, a, mpc, bc = problem(16, np.exp(1j * np.pi / 3))
    L = dmt.LinearForm(V, lambda v, c: (4.0 + 2.0j * c.x[0]) * v.value)
    ops, masks = build_gmg_hierarchy(level, 8, 3, min_n=4)
    return ShardedLatticeProblem(a, L, mpc, [bc], device_mesh=jx_mesh(8), dtype=np.complex128, rtol=1e-12,
                                 pc_type="gmg", sharded_levels=2,
                                 coarse_gmg=LatticeGMG(ops, free_masks=masks if with_masks else None))


def test_jax_middle_level_drops_the_imaginary_diagval():
    """The JAX package's sharded middle level at the Bloch case's input
    holds real(1 + 0.5i) = 1.0 (parallel/lattice_spmd.py:485); the port's
    holds 1 + 0.5i (above)."""
    p = _jax_bloch_problem(True)
    assert p._mid_dv == 1.0 != cases.BLOCH_LEVEL_DIAGVAL


@pytest.mark.parametrize("with_masks", [True, False], ids=["free_masks", "no_masks"])
def test_jax_middle_diagval_moves_no_count(port_runs, with_masks):
    """Why the :485 defect shows in no solution: the JAX solve of the Bloch
    case with the middle level's diagval as the package holds it (1.0) and
    with it set to the assembled 1 + 0.5i takes the same CG count and gives
    the same bits, with the hierarchy's free masks and without them — the
    middle level's slave rows carry only zeros when diagval multiplies
    them.  The port (diagval 1 + 0.5i) takes that count too."""
    got = []
    for dv in (None, cases.BLOCH_LEVEL_DIAGVAL):
        p = _jax_bloch_problem(with_masks)
        if dv is not None:
            p._mid_dv = dv
        u, its, _ = p.solve()
        got.append((np.asarray(u), int(its)))
    assert got[0][1] == got[1][1]
    assert np.array_equal(got[0][0], got[1][0])
    if with_masks:
        assert abs(port_runs[8][0]["bloch16"]["its"] - got[0][1]) <= 1
