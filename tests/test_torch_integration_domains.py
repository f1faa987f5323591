"""Cell integrals over cell subsets (entities= on cell forms) through the
port's general assembler against the JAX package's, in the real dtypes
(tests/test_integration_domains.py; its complex128 case is in
tests/test_torch_complex.py): the constrained matrix equals the JAX
package's and the K^H A K oracle."""

import numpy as np
import pytest
import scipy.sparse as sp

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as JF
from dolfinx_mpc_tpu.fem import mesh as JM
from dolfinx_mpc_tpu_torch.fem import forms as PF
from dolfinx_mpc_tpu_torch.fem import mesh as PM
from dolfinx_mpc_tpu_torch.utils import compare_mpc_lhs


def _subdomain_form(pkg, F, M, dtype):
    """a = 2 grad.grad on the left half + 5 u v on the right half of the
    unit square, and the reference test's two-master general constraint."""
    mesh = M.create_unit_square(4, 4)
    V = pkg.functionspace(mesh, ("Lagrange", 1))
    left = M.locate_entities(mesh, mesh.tdim, lambda x: x[0] <= 0.5 + 1e-12)
    right = np.setdiff1d(np.arange(mesh.num_cells), left)
    a = (pkg.BilinearForm(V, lambda u, v, c: 2.0 * F.inner(F.grad(u), F.grad(v)), entities=left)
         + pkg.BilinearForm(V, lambda u, v, c: 5.0 * F.inner(u, v), entities=right))
    mpc = pkg.MultiPointConstraint(V, dtype, **({"device": "cpu"} if pkg is pt else {}))
    mpc.create_general_constraint({np.array([1.0, 1.0]).tobytes(): {
        np.array([0.25, 1.0]).tobytes(): 0.5, np.array([0.0, 1.0]).tobytes(): 0.5}})
    mpc.finalize()
    return a, mpc


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13), (np.float32, 1e-6)])
def test_cell_subdomains(dtype, tol):
    aj, mpcj = _subdomain_form(jx, JF, JM, dtype)
    ap, mpcp = _subdomain_form(pt, PF, PM, dtype)
    for constraint_j, constraint_p in ((None, None), (mpcj, mpcp)):
        Aj = jx.assemble_matrix(aj, constraint_j, dtype=dtype).to_scipy()
        Ap = pt.assemble_matrix(ap, constraint_p, dtype=dtype, device="cpu").to_scipy()
        assert Ap.dtype == np.dtype(dtype)
        assert abs(sp.csr_matrix(Ap, dtype=np.float64) - sp.csr_matrix(Aj, dtype=np.float64)).max() \
            <= tol * abs(Aj).max()
    A_org = pt.assemble_matrix(ap, None, dtype=np.float64, device="cpu").to_scipy()
    A_mpc = pt.assemble_matrix(ap, mpcp, dtype=np.float64, device="cpu").to_scipy()
    compare_mpc_lhs(A_org, A_mpc, mpcp)
    # the subsets matter: the whole-domain sum of the two terms differs
    whole = (pt.BilinearForm(ap.test_space, lambda u, v, c: 2.0 * PF.inner(PF.grad(u), PF.grad(v)))
             + pt.BilinearForm(ap.test_space, lambda u, v, c: 5.0 * PF.inner(u, v)))
    assert abs(pt.assemble_matrix(whole, None, dtype=np.float64, device="cpu").to_scipy() - A_org).max() > 0.1
