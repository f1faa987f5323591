"""la/solvers.py: cg and the Jacobi preconditioner on tensors of any shape,
against the JAX package's cg (jnp.vdot flattens; the degree-2 path runs CG
on the 4-D padded class stack)."""

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.la.solvers import cg as jx_cg
from dolfinx_mpc_tpu_torch.la.solvers import jacobi_preconditioner

SHAPE = (2, 3, 3, 3)


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    return Q @ Q.T + n * np.eye(n)


@pytest.mark.parametrize("precondition", [False, True])
def test_cg_flat_and_stacked_match_jax(precondition):
    import jax.numpy as jnp

    n = int(np.prod(SHAPE))
    A = _spd(n)
    b = np.random.default_rng(1).standard_normal(n)
    d = np.diag(A).copy()
    At = torch.as_tensor(A)
    runs = []
    for shape in ((n,), SHAPE):
        Mp = jacobi_preconditioner(torch.as_tensor(d).reshape(shape)) if precondition else None
        xp, its_p, rn_p = pt.cg(lambda v: (At @ v.reshape(-1)).reshape(shape),
                                torch.as_tensor(b).reshape(shape), M=Mp, rtol=1e-10, atol=0.0)
        Aj = jnp.asarray(A)
        dj = jnp.asarray(d).reshape(shape)
        Mj = (lambda r: r / dj) if precondition else None
        xj, its_j, rn_j = jx_cg(lambda v: (Aj @ v.reshape(-1)).reshape(shape),
                                jnp.asarray(b).reshape(shape), M=Mj, rtol=1e-10, atol=0.0)
        assert tuple(xp.shape) == shape
        assert its_p == int(its_j) and its_p > 1
        assert np.abs(xp.numpy() - np.asarray(xj)).max() < 1e-12 * np.abs(np.asarray(xj)).max()
        runs.append((xp.reshape(-1).numpy(), its_p))
    (x_flat, its_flat), (x_stack, its_stack) = runs
    assert its_flat == its_stack
    assert np.abs(x_flat - x_stack).max() < 1e-12 * np.abs(x_flat).max()


def test_cg_on_a_stack_converges_at_once_on_a_scaled_identity():
    """The reproduction of the fault: a 4-D right-hand side."""
    x, its, rnorm = pt.cg(lambda v: 2 * v, torch.ones(SHAPE, dtype=torch.float64))
    assert (its, rnorm) == (1, 0.0)
    assert torch.equal(x, torch.full(SHAPE, 0.5, dtype=torch.float64))
