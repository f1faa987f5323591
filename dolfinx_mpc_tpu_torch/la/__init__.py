"""Linear algebra: Krylov solvers (CG, BiCGStab, GMRES) and their Jacobi
and Chebyshev preconditioners, the shift-and-invert eigensolver, the
lattice geometric multigrid, the unstructured sparse formats (slot CSR,
node-block ELL, blocked ELL with kernel K8) and smoothed-aggregation AMG."""

from .eig import eigsh_shift_invert
from .gmg import LatticeGMG, build_gmg_hierarchy
from .solvers import (
    SolverOptions,
    bicgstab,
    cg,
    chebyshev_preconditioner,
    gmres,
    jacobi_preconditioner,
)
from .sparse import CSRMatrix, SlotPattern, build_slot_pattern
