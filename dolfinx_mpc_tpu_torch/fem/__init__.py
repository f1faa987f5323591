"""Mini-FEM substrate: meshes, Lagrange spaces, quadrature, UFL-lite forms,
geometry maps (numpy host code; forms evaluate on torch tensors)."""

from .forms import BilinearForm, Form, LinearForm, derivative
from .functionspace import (
    DirichletBC,
    Function,
    FunctionSpace,
    dirichletbc,
    functionspace,
    locate_dofs_geometrical,
    locate_dofs_topological,
)
from .mesh import (
    Mesh,
    MeshTags,
    create_box,
    create_rectangle,
    create_unit_cube,
    create_unit_interval,
    create_unit_square,
    locate_entities,
    locate_entities_boundary,
    meshtags,
)
