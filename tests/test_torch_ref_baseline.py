"""The port's constrained operators against the C++ CPU reference baseline
(csrc/ref_baseline.cpp), as tests/test_ref_baseline.py holds the JAX
package's: the periodic problem of the benchmark on the n=4 unit cube
(periodic in x, Dirichlet 0 at y = 0 and 1), P1 and P2 Poisson and bs=3
P1 elasticity (mu = 1, lambda = 1.25), assembled K^T A K with 1 on the
slave and Dirichlet diagonals.  Each case holds the port's general
assembler (assemble_matrix) and its lattice operator (assemble_matrix_lattice,
side formats "fold" and "csr") against the C++ matrix, renumbered by dof
coordinates, to 1e-12; float64 on the CPU.

The binary is compiled with g++ into the test's own temporary directory
(the flags of benchmarks/ref_cpu_baseline.py), so that this file and
tests/test_ref_baseline.py never share one binary under parallel workers.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp

import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube

SRC = Path(__file__).resolve().parents[1] / "csrc" / "ref_baseline.cpp"
N = 4
# case: (degree, block size)
CASES = {"P1": (1, 1), "P2": (2, 1), "bs3": (1, 3)}
OPERATORS = ("general", "fold", "csr")


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    out = tmp_path_factory.mktemp("ref_baseline") / "ref_baseline"
    subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-std=c++17", str(SRC), "-o", str(out)],
                   check=True, capture_output=True)
    return out


def _cpp_matrix(binary, dump, degree, bs):
    """(node coordinates, the C++ operator as scipy CSR)."""
    subprocess.run([str(binary), str(N), "1", str(degree), str(dump), str(bs)], check=True, capture_output=True)
    coords, rows, cols, vals = [], [], [], []
    for line in dump.read_text().splitlines():
        parts = line.split()
        if parts[0] == "v":
            coords.append([float(p) for p in parts[1:]])
        else:
            rows.append(int(parts[1]))
            cols.append(int(parts[2]))
            vals.append(float(parts[3]))
    n_dofs = len(coords) * bs
    return np.asarray(coords), sp.csr_matrix((vals, (rows, cols)), shape=(n_dofs, n_dofs))


def _port_problem(degree, bs):
    mesh = create_unit_cube(N, N, N)
    V = pt.functionspace(mesh, ("Lagrange", degree) if bs == 1 else ("Lagrange", degree, (bs,)))
    bdofs = pt.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0))
    bc = pt.dirichletbc(0.0 if bs == 1 else np.zeros(bs), bdofs, V)
    mpc = pt.MultiPointConstraint(V, np.float64, device="cpu")
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    if bs == 1:
        a = pt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=degree)
    else:
        a = pt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v)))
                            + 1.25 * div(u) * conj(div(v)), quad_degree=1)
    return V, a, mpc, bc


def _renumber(A_cpp, coords, V, degree, bs):
    """The C++ matrix in the port's dof numbering: nodes matched by their
    coordinates on the (degree n + 1)^3 grid, components interleaved."""
    X = V.tabulate_dof_coordinates()
    if X.shape[0] == len(coords) * bs:  # one row per component -> one per node
        X = X[::bs]
    gp = degree * N + 1
    key = lambda P: np.round(P * (gp - 1)).astype(np.int64) @ np.array([gp ** 2, gp, 1])  # noqa: E731
    nperm = np.empty(len(coords), dtype=np.int64)  # C++ node -> port node
    nperm[np.argsort(key(coords))] = np.argsort(key(X))
    perm = (nperm[:, None] * bs + np.arange(bs)).ravel()
    n_dofs = len(perm)
    P = sp.csr_matrix((np.ones(n_dofs), (perm, np.arange(n_dofs))), shape=(n_dofs, n_dofs))
    return (P @ A_cpp @ P.T).tocsr()


@pytest.mark.parametrize("operator", OPERATORS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_port_operator_matches_cpp_baseline(binary, tmp_path, case, operator):
    degree, bs = CASES[case]
    coords, A_cpp = _cpp_matrix(binary, tmp_path / "mat.txt", degree, bs)
    V, a, mpc, bc = _port_problem(degree, bs)
    if operator == "general":
        A = pt.assemble_matrix(a, mpc, bcs=[bc], diagval=1.0)
    else:
        A = pt.assemble_matrix_lattice(a, mpc, bcs=[bc], diagval=1.0, side_format=operator,
                                       device="cpu").assemble()
    A = A.to_scipy().tocsr()
    assert A.shape == A_cpp.shape == (V.num_dofs, V.num_dofs)
    diff = _renumber(A_cpp, coords, V, degree, bs) - A
    assert (np.abs(diff.data).max() if diff.nnz else 0.0) < 1e-12
