"""dolfinx_mpc_tpu_torch: constrained finite elements on PyTorch and CUDA.

The PyTorch port of ``dolfinx_mpc_tpu`` (the JAX reference, which stays in
the repository unchanged).  The public names mirror the JAX package's, and a
module's counterpart sits at the same path.  Devices and dtypes are explicit:
``MultiPointConstraint(V, dtype, device=...)``, ``assemble_matrix_lattice(...,
device=...)``, ``assemble_matrix(..., device=...)``, ``bell_from_scipy(...,
device=...)`` and ``smoothed_aggregation_amg(..., device=...)`` place the
tables and operators, and everything downstream follows them.  Every such
entry point defaults to ``device="cuda"`` and raises without a card; CPU
callers pass ``device="cpu"``.  The lattice path's kernels (the fused
lean-fold assemblers K1, K3 and K4, the unmasked assembler K5, the scalar
and vector DIA SpMVs K2 and K7 and the blocked SpMV K6) and the
unstructured path's blocked-ELL SpMV K8 are CUDA C++ for sm_90a in
``csrc/``, built with nvcc on first use; on CPU tensors their plain PyTorch
versions run instead.
"""

import torch as _torch

# Full-precision float32 products package-wide, the counterpart of the JAX
# package's jax_default_matmul_precision="highest": TF32 keeps ~3 decimal
# digits, which the dense coarse solve and CG's dot products cannot absorb.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .fem import cells, forms, mesh  # noqa: E402
from .fem.forms import BilinearForm, Form, LinearForm  # noqa: E402
from .fem.functionspace import (  # noqa: E402
    DirichletBC,
    Function,
    FunctionSpace,
    dirichletbc,
    functionspace,
    locate_dofs_geometrical,
    locate_dofs_topological,
)
from .la.gmg import LatticeGMG, build_gmg_hierarchy  # noqa: E402
from .la.solvers import cg  # noqa: E402
from .multipointconstraint import FinalizedMPC, MPCData, MultiPointConstraint  # noqa: E402
from .ops.assemble import (  # noqa: E402
    apply_lifting,
    assemble_matrix,
    assemble_vector,
    create_sparsity_pattern,
    set_bc,
)
from .ops.lattice import assemble_matrix_lattice  # noqa: E402
from .problem import LinearProblem  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "assemble_matrix",
    "create_sparsity_pattern",
    "assemble_matrix_lattice",
    "assemble_vector",
    "apply_lifting",
    "set_bc",
    "MultiPointConstraint",
    "MPCData",
    "FinalizedMPC",
    "LinearProblem",
    "LatticeGMG",
    "build_gmg_hierarchy",
    "cg",
    "Function",
    "FunctionSpace",
    "functionspace",
    "dirichletbc",
    "DirichletBC",
    "locate_dofs_geometrical",
    "locate_dofs_topological",
    "BilinearForm",
    "LinearForm",
    "Form",
]
