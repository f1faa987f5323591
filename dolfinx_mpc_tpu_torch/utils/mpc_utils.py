"""User utilities: normal approximation, rigid-body nullspaces, rotations.

Counterpart of ``dolfinx_mpc_tpu/utils/mpc_utils.py``.  The geometry is host
numpy, copied; the ``Function``s returned hold their values on an explicit
device (``device="cuda"`` by default), and ``facet_normal_approximation``'s
projection assembles its two exterior-facet forms and solves with
Jacobi-CG on that device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..fem.functionspace import Function, FunctionSpace, locate_dofs_topological
from ..fem.geometry_maps import cell_coords, geom_tabulation, reference_facet_normals
from ..fem.mesh import Mesh, MeshTags

__all__ = [
    "rotation_matrix",
    "create_normal_approximation",
    "facet_normal_approximation",
    "rigid_motions_nullspace",
    "log_info",
]


def rotation_matrix(axis, angle) -> np.ndarray:
    """Rodrigues rotation (reference mpc_utils.py:35-48)."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def _facet_outward_normals(mesh: Mesh, facets: np.ndarray) -> np.ndarray:
    """Unit outward normal per given exterior facet (affine geometry)."""
    _, cell_to_f, f2c = mesh.facets()
    cells = f2c[facets, 0]
    lf = np.argmax(cell_to_f[cells] == facets[:, None], axis=1)
    ref_n = reference_facet_normals(mesh.cell_type)  # (n_lf, tdim)
    # J at cell center
    center = mesh.ref_cell.vertices.mean(axis=0)[None, :]
    _, dphi = geom_tabulation(mesh.cell_type, center)
    cc = cell_coords(mesh, cells)
    J = np.einsum("cvg,qvt->cgt", cc, dphi)  # (n, gdim, tdim)
    Jinv = np.linalg.inv(J)
    n = np.einsum("ctg,ct->cg", Jinv, ref_n[lf])  # J^{-T} N
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    return n


def _function(V, values: np.ndarray, name: str, device) -> Function:
    return Function(V, values.reshape(-1), name=name, device=device)


def create_normal_approximation(V: FunctionSpace, mt: MeshTags, tag: int, device=DEFAULT_DEVICE) -> Function:
    """Averaged outward facet normal at the dofs of the tagged facets
    (reference cpp/utils.h:199-267), as a float64 Function on `device`."""
    base = V if V.parent is None else V.parent
    bs = base.block_size
    assert bs == base.mesh.gdim, "normal approximation needs a vector space"
    device = resolve_device(device)
    facets = mt.find(tag)
    normals = _facet_outward_normals(base.mesh, facets)
    acc = np.zeros((base.num_blocks, bs))
    fdim = base.mesh.tdim - 1
    for f, n in zip(facets, normals):
        blocks = locate_dofs_topological(base, fdim, np.asarray([f]))
        acc[blocks] += n
    norms = np.linalg.norm(acc, axis=1)
    nz = norms > 0
    acc[nz] /= norms[nz, None]
    return _function(base, acc, "n_approx", device)


def facet_normal_approximation(
    V, mt: MeshTags, mt_id: int, tangent=False, method="project", device=DEFAULT_DEVICE, **kwargs
) -> Function:
    """Projection of the facet normal onto V (reference mpc_utils.py:51-148):
    solve  inner(n_h, v) ds(mt_id) = inner(n, v) ds(mt_id)  with every dof NOT
    on the tagged facets deactivated via a zero DirichletBC (the reference's
    'deactivated-interior' trick), assembled and solved (Jacobi-CG, rtol
    1e-12) in float64 on `device`.  `method="average"` takes the averaged
    geometric normal (the C++ `create_normal_approximation` path);
    `tangent=True` rotates to a unit tangent."""
    device = resolve_device(device)
    base = V if V.parent is None else V.parent
    bs = base.block_size
    if method == "project" and not tangent:
        from ..fem.forms import BilinearForm, LinearForm, inner
        from ..fem.functionspace import dirichletbc
        from ..la.solvers import cg, jacobi_preconditioner
        from ..ops.assemble import assemble_matrix, assemble_vector, set_bc

        facets = mt.find(mt_id)
        a = BilinearForm(
            base, lambda u, v, c: inner(u, v), integral="exterior_facet", entities=facets
        )
        L = LinearForm(
            base, lambda v, c: inner(c.n, v), integral="exterior_facet", entities=facets
        )
        on_facets = locate_dofs_topological(base, base.mesh.tdim - 1, facets)
        deactivated = np.setdiff1d(np.arange(base.num_blocks), on_facets)
        bc = dirichletbc(np.zeros(bs) if bs > 1 else 0.0, deactivated, base)
        A = assemble_matrix(a, None, bcs=[bc], diagval=1.0, dtype=np.float64, device=device)
        b = set_bc(assemble_vector(L, None, dtype=np.float64, device=device), [bc])
        x, _, _ = cg(A.matvec, b, M=jacobi_preconditioner(A.diagonal()), rtol=1e-12)
        arr = x.reshape(-1, bs)
        norms = torch.linalg.vector_norm(arr, dim=1)
        arr = torch.where((norms > 1e-13)[:, None], arr / norms[:, None], arr)
        return Function(base, arr.reshape(-1), name="n_proj", device=device)

    nh = create_normal_approximation(V, mt, mt_id, device=device)
    if not tangent:
        return nh
    arr = nh.x.array.cpu().numpy().reshape(-1, bs)
    tang = np.zeros_like(arr)
    for i, n in enumerate(arr):
        if np.linalg.norm(n) == 0:
            continue
        if bs == 2:
            tang[i] = [-n[1], n[0]]
        else:
            ref = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
            t = np.cross(n, ref)
            tang[i] = t / np.linalg.norm(t)
    nh.x.array.copy_(torch.as_tensor(tang.reshape(-1), device=device))
    return nh


def rigid_motions_nullspace(V: FunctionSpace):
    """Orthonormal rigid-body modes (reference mpc_utils.py:163-215):
    translations + rotations; returned as a (num_dofs, n_modes) array."""
    base = V if V.parent is None else V.parent
    gdim = base.mesh.gdim
    bs = base.block_size
    assert bs == gdim
    num_modes = 3 if gdim == 2 else 6
    N = base.num_dofs
    basis = np.zeros((N, num_modes))
    coords = base.dof_coords_blocks
    for k in range(gdim):
        basis[k :: bs, k][:] = 1.0
    if gdim == 2:
        basis[0::bs, 2] = -coords[:, 1]
        basis[1::bs, 2] = coords[:, 0]
    else:
        basis[0::bs, 3] = -coords[:, 1]
        basis[1::bs, 3] = coords[:, 0]
        basis[0::bs, 4] = coords[:, 2]
        basis[2::bs, 4] = -coords[:, 0]
        basis[2::bs, 5] = coords[:, 1]
        basis[1::bs, 5] = -coords[:, 2]
    q, _ = np.linalg.qr(basis)
    return q


def log_info(message: str):
    """Rank-0 logging shim (reference mpc_utils.py:151-160)."""
    print(message)
