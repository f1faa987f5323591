"""Parity of the port's single-device forward step (dolfinx_mpc_tpu_torch/
entry.py) with the JAX package's entry() (__graft_entry__.py): the same
periodic Poisson problem at n=8, the same load vector b (1e-14), and one
step (assembly of K^H A K, 50 CG iterations with no early exit,
backsubstitution) on the same b to 1e-12 relative, both in float64 on the
CPU.  The step also lies within 1e-10 of the direct solve of the assembled
system followed by backsubstitution, and leaves its result on b's device.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu_torch.parallel.dryrun import build_problem

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__  # noqa: E402


@pytest.fixture(scope="module")
def steps():
    """(JAX step, JAX b, port step, port b)."""
    step_j, (b_j,) = __graft_entry__.entry()
    step_p, (b_p,) = pt.entry(device="cpu")
    return jax.jit(step_j), np.asarray(b_j), step_p, b_p


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_b_equal_jax(steps):
    _, b_j, _, b_p = steps
    assert b_p.dtype == torch.float64 and b_p.device.type == "cpu"
    assert np.abs(b_p.numpy() - b_j).max() <= 1e-14 * np.abs(b_j).max()


def test_step_equal_jax(steps):
    step_j, b_j, step_p, b_p = steps
    u_j = np.asarray(step_j(b_j))
    u_p = step_p(torch.as_tensor(b_j.copy()))
    assert u_p.device == b_p.device and u_p.dtype == torch.float64
    assert _rel(u_p.numpy(), u_j) <= 1e-12


def test_step_equals_direct_solve(steps):
    """u = K A^-1 b with A the assembled constrained matrix (diagval 1)."""
    _, _, step_p, b_p = steps
    V, a, _, mpc, bc = build_problem(8, device="cpu")
    A = pt.assemble_matrix(a, mpc, bcs=[bc], diagval=1.0).to_scipy().tocsc()
    x = torch.as_tensor(spla.spsolve(A, b_p.numpy()))
    u_ref = mpc.finalized.backsubstitution(x).numpy()
    assert _rel(step_p(b_p).numpy(), u_ref) <= 1e-10
