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
versions run instead.  Constraint generators (periodic, slip, contact slip
and tied contact, dictionary, point-to-point), exterior-facet integrals,
the normal approximations (utils), gmsh I/O (io), mixed spaces, nest
blocks, the matrix-free operator (ops.matfree), the Krylov methods and the
eigensolver (la), the Newton drivers and the demos
(``dolfinx_mpc_tpu_torch/demos``) run on the same entry points.
"""

import torch as _torch

# Full-precision float32 products package-wide, the counterpart of the JAX
# package's jax_default_matmul_precision="highest": TF32 keeps ~3 decimal
# digits, which the dense coarse solve and CG's dot products cannot absorb.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from .fem import cells, forms, mesh  # noqa: E402
from .fem.forms import BilinearForm, Form, LinearForm, derivative  # noqa: E402
from .fem.functionspace import (  # noqa: E402
    DirichletBC,
    Function,
    FunctionSpace,
    dirichletbc,
    functionspace,
    locate_dofs_geometrical,
    locate_dofs_topological,
)
from .fem.mixed import MixedFunctionSpace, mixed_functionspace, split  # noqa: E402
from .entry import entry  # noqa: E402
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
from .ops.nest import (  # noqa: E402
    assemble_matrix_nest,
    assemble_vector_nest,
    create_matrix_nest,
    create_vector_nest,
)
from .problem import LinearProblem, NonlinearProblem, NonlinearProblemNest  # noqa: E402

__version__ = "0.1.0"

from . import io  # noqa: E402  (XDMFFile, read_gmsh, write_gmsh)
from .utils.timing import Timer, list_timings, timed  # noqa: E402

__all__ = [
    "assemble_matrix",
    "create_matrix_nest",
    "assemble_matrix_nest",
    "create_sparsity_pattern",
    "assemble_matrix_lattice",
    "assemble_vector",
    "assemble_vector_nest",
    "create_vector_nest",
    "apply_lifting",
    "set_bc",
    "MultiPointConstraint",
    "MPCData",
    "FinalizedMPC",
    "LinearProblem",
    "NonlinearProblem",
    "NonlinearProblemNest",
    "LatticeGMG",
    "build_gmg_hierarchy",
    "cg",
    "Function",
    "FunctionSpace",
    "functionspace",
    "MixedFunctionSpace",
    "mixed_functionspace",
    "split",
    "dirichletbc",
    "DirichletBC",
    "locate_dofs_geometrical",
    "locate_dofs_topological",
    "BilinearForm",
    "LinearForm",
    "Form",
    "derivative",
    "Timer",
    "timed",
    "list_timings",
    "entry",
]
