from .mpc_utils import (
    create_normal_approximation,
    facet_normal_approximation,
    log_info,
    rigid_motions_nullspace,
    rotation_matrix,
)
from .verification import (
    assemble_matrix_scipy,
    compare_mpc_lhs,
    compare_mpc_rhs,
    gather_PETScMatrix,
    gather_PETScVector,
    gather_transformation_matrix,
)
