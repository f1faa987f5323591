"""Linear algebra: Krylov solvers, the lattice geometric multigrid, the
unstructured sparse formats (slot CSR, node-block ELL, blocked ELL with
kernel K8) and smoothed-aggregation AMG."""

from .gmg import LatticeGMG, build_gmg_hierarchy
from .solvers import SolverOptions, cg, jacobi_preconditioner
