"""The port's general distributed path (dolfinx_mpc_tpu_torch/parallel/
spmd.py) on spawned gloo ranks on the CPU against the JAX package's
ShardedLinearProblem on 8 virtual CPU devices: the slot pattern, row
partition and ghost-exchange tables bit for bit, the cases of
tests/test_spmd.py at 1, 4 and 8 ranks against the JAX solve and the
K (K^T A K)^-1 K^T b oracle (1e-8), tied contact against the single-device
solve; and the collectives and the launcher themselves.  One spawned group
per rank count serves every case (a module fixture)."""

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import torch_spmd_cases as cases
from dolfinx_mpc_tpu_torch.parallel import run_ranks
from dolfinx_mpc_tpu_torch.parallel import spmd as pspmd

RANKS = (1, 4, 8)


@pytest.fixture(scope="module")
def port_runs():
    return {n: run_ranks(cases.general_rank, n, backend="gloo", device="cpu") for n in RANKS}


def _jax_problem(n_dev):
    import dolfinx_mpc_tpu as dmt
    from dolfinx_mpc_tpu.fem.forms import grad, inner
    from dolfinx_mpc_tpu.fem.mesh import create_unit_square
    from dolfinx_mpc_tpu.parallel import ShardedLinearProblem, make_device_mesh

    mesh = create_unit_square(12, 12)
    V = dmt.functionspace(mesh, ("Lagrange", 1))
    bc = dmt.dirichletbc(0.3, dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)
                                                          | np.isclose(x[1], 1.0)), V)
    mpc = dmt.MultiPointConstraint(V)
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    L = dmt.LinearForm(V, lambda v, c: (1.0 + c.x[0] * 0.0) * v.value)
    prob = ShardedLinearProblem(a, L, mpc, [bc], device_mesh=make_device_mesh(n_dev), rtol=1e-12)
    return dmt, V, a, L, mpc, bc, prob


@pytest.mark.parametrize("n_dev", RANKS)
def test_tables_bit_equal_to_jax(port_runs, n_dev):
    """Slot pattern, RowPartition and the ghost-exchange tables of the
    port's ShardedLinearProblem equal the JAX package's, and the port's
    partition_rows / build_ghost_exchange give the JAX tables from the JAX
    pattern."""
    from dolfinx_mpc_tpu.parallel.spmd import build_ghost_exchange, partition_rows

    *_, jprob = _jax_problem(n_dev)
    got = port_runs[n_dev][0]["tables"]
    jp = jprob.pattern
    for k in ("indptr", "indices", "row_ids"):
        assert np.array_equal(got[k], getattr(jp, k)), k
    for k, v in vars(jprob.part).items():
        assert np.array_equal(np.asarray(got["part"][k]), np.asarray(v)), k
    assert got["window"] == jprob._window
    part = pspmd.partition_rows(jp, n_dev)
    ref = partition_rows(jp, n_dev)
    for k, v in vars(ref).items():
        a = np.asarray(getattr(part, k))
        assert a.dtype == np.asarray(v).dtype and np.array_equal(a, np.asarray(v)), k
    rounds, lcols, window = pspmd.build_ghost_exchange(part)
    r_ref, l_ref, w_ref = build_ghost_exchange(ref)
    assert window == w_ref and np.array_equal(lcols, l_ref) and lcols.dtype == l_ref.dtype
    assert [d for d, _ in rounds] == [d for d, _ in r_ref]
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for (_, a), (_, b) in zip(rounds, r_ref))


@pytest.mark.parametrize("n_dev", RANKS)
def test_matches_jax_and_oracle(port_runs, n_dev):
    """tests/test_spmd.py::test_sharded_matches_oracle on the port: every
    rank's solution equals the JAX sharded solve and the oracle to 1e-8,
    in the JAX package's CG count."""
    from dolfinx_mpc_tpu.utils import gather_transformation_matrix

    dmt, V, a, L, mpc, bc, jprob = _jax_problem(n_dev)
    uj, itsj, _ = jprob.solve()
    A = dmt.assemble_matrix(a, None, bcs=[bc]).to_scipy()
    b = np.asarray(dmt.set_bc(dmt.apply_lifting(np.asarray(dmt.assemble_vector(L, None)), [a], [[bc]], None), [bc]))
    K = gather_transformation_matrix(mpc)
    u_ref = K @ spla.spsolve((K.T @ A @ K).tocsr(), K.T @ b)
    for r in port_runs[n_dev]:
        u = r["p2d"]["u"]
        assert np.abs(u - u_ref).max() < 1e-8
        assert np.abs(u - np.asarray(uj)).max() < 1e-8
        assert r["p2d"]["its"] == itsj


def test_contact_matches_single_device(port_runs):
    """tests/test_spmd.py's tied contact on 8 ranks: the distributed CG
    equals the single-device assembled solve, and each rank's ghost window
    is well below the problem size."""
    import dolfinx_mpc_tpu_torch as pt
    from dolfinx_mpc_tpu_torch.parallel.dryrun import contact_problem

    V, a, L, mpc, bcs = contact_problem(6, 5, device="cpu")
    A = pt.assemble_matrix(a, mpc, bcs=bcs, device="cpu")
    b = pt.set_bc(pt.apply_lifting(pt.assemble_vector(L, mpc), [a], [bcs], mpc), bcs)
    x, _, _ = pt.cg(A.matvec, b, rtol=1e-10, max_it=4000)
    u1 = mpc.finalized.backsubstitution(x).numpy()
    nrm = max(np.abs(u1).max(), 1e-30)
    for r in port_runs[8]:
        c = r["contact"]
        assert c["its"] > 20
        assert np.abs(c["u"] - u1).max() < 1e-6 * nrm
        assert c["window"] < 0.55 * c["dofs"]


def test_3d_periodic_faces_agree(port_runs):
    """tests/test_spmd.py::test_sharded_3d_runs on 8 ranks."""
    V, *_ = cases.periodic_cube(3)
    u = port_runs[8][0]["cube"]["u"]
    assert np.isfinite(u).all() and port_runs[8][0]["cube"]["its"] > 0
    coords = V.dof_coords_blocks
    lo = np.flatnonzero(np.isclose(coords[:, 0], 0.0))
    hi = np.flatnonzero(np.isclose(coords[:, 0], 1.0))
    key = lambda idx: np.lexsort((coords[idx, 2], coords[idx, 1]))  # noqa: E731
    assert np.abs(u[lo[key(lo)]] - u[hi[key(hi)]]).max() < 1e-7


def test_ranks_return_the_same_solution(port_runs):
    for n in RANKS:
        for r in port_runs[n][1:]:
            assert np.array_equal(r["p2d"]["u"], port_runs[n][0]["p2d"]["u"])


@pytest.fixture(scope="module")
def collectives():
    return run_ranks(cases.collectives_rank, 4, backend="gloo", device="cpu")


def test_collectives(collectives):
    """RankGrid on a (2, 2) grid: rank = ix * 2 + iy; psum over both axes,
    over "sx" and "sy" alone, pmax; the tiled reduce-scatter and all-gather
    (float64 and complex128); ring and one-way ppermutes, zeros where no
    pair sends."""
    xs = [np.arange(4.0) + 10 * r for r in range(4)]
    total = sum(xs)
    for r, out in enumerate(collectives):
        ix, iy = divmod(r, 2)
        assert out["coords"] == (ix, iy)
        assert not out["jax_loaded"]  # a rank imports the port alone
        assert out["psum"] == 6.0 and out["pmax"] == 3.0 and out["psum_c"] == 6j
        assert out["psum_x"] == iy + (2 + iy)  # ranks (0, iy) and (1, iy)
        assert out["psum_y"] == 2 * ix + (2 * ix + 1)
        assert np.array_equal(out["scatter"], total[r:r + 1])
        assert np.array_equal(out["scatter_c"], total[r:r + 1] * (1 + 2j))
        assert np.array_equal(out["gather"], np.concatenate([x[:2] for x in xs]))
        assert np.array_equal(out["gather_c"], np.concatenate([x[:2] for x in xs]) * (1 + 2j))
        assert np.array_equal(out["ring_x"], xs[((ix - 1) % 2) * 2 + iy])
        assert np.array_equal(out["ring_y_c"], xs[ix * 2 + (iy + 1) % 2] * (1 + 2j))
        assert np.array_equal(out["one_way"], xs[iy] if ix == 1 else np.zeros(4))


def test_a_failing_rank_fails_the_call():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException, match="rank 1 fails on purpose"):
        run_ranks(cases.failing_rank, 2, backend="gloo", device="cpu")


def test_transport_is_the_callers():
    """No fallback: an unknown transport, or NCCL without cards, is refused
    before any rank starts."""
    with pytest.raises(ValueError, match="unknown transport"):
        run_ranks(cases.failing_rank, 2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="NCCL"):
        run_ranks(cases.failing_rank, 2, backend="nccl", device="cpu")
