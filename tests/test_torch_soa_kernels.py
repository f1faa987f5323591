"""The cells-last SoA element kernel (ops/soa_kernels.py) against the JAX
package's (dolfinx_mpc_tpu/ops/soa_kernels.py) on the CPU: for each form the
JAX kernel takes — P1 and P2 tets, quadrilaterals, vector elasticity,
x-dependent, complex and coefficient forms — the support test,
the recovered feature matrix (its structural nonzeros and constant values)
and the element tensors (1e-12 relative in float64 / complex128, 5e-6 in
float32 / complex64); the forms it refuses (hexahedra, P2 tets at the
default degree) are refused by both."""

import inspect

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as JF
from dolfinx_mpc_tpu.fem import mesh as JM
from dolfinx_mpc_tpu.ops.soa_kernels import compile_cell_kernel_soa as jax_soa
from dolfinx_mpc_tpu_torch.fem import forms as PF
from dolfinx_mpc_tpu_torch.fem import mesh as PM
from dolfinx_mpc_tpu_torch.ops.soa_kernels import compile_cell_kernel_soa as port_soa
from dolfinx_mpc_tpu_torch.ops.soa_kernels import soa_supported

PKGS = {"jx": (jx, JF, JM), "pt": (pt, PF, PM)}


def _coefficient(pkg, V, fn):
    w = pkg.Function(V, **({"device": "cpu"} if pkg is pt else {}))
    w.interpolate(fn)
    return w


def _form(name, which):
    """(mesh, V, bilinear form) of the named case, through one package."""
    pkg, F, M = PKGS[which]
    grad, inner = F.grad, F.inner
    if name == "p1_tet":
        mesh = M.create_unit_cube(3, 2, 2)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    if name == "p1_tet_mass":
        mesh = M.create_unit_cube(2, 2, 3)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)) + 0.5 * u.value * F.conj(v.value))
    if name == "p2_tet":
        mesh = M.create_unit_cube(2, 2, 2)
        V = pkg.functionspace(mesh, ("Lagrange", 2))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=2)
    if name == "hex":
        mesh = M.create_unit_cube(2, 2, 2, "hexahedron")
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=1)
    if name == "quad":
        mesh = M.create_unit_square(3, 3, "quadrilateral")
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)) + u.value * F.conj(v.value))
    if name == "elasticity":
        mesh = M.create_unit_cube(2, 2, 2)
        V = pkg.functionspace(mesh, ("Lagrange", 1, (3,)))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: 2 * inner(F.sym(grad(u)), F.sym(grad(v)))
                                         + 1.25 * F.div(u) * F.conj(F.div(v)), quad_degree=1)
    if name == "x_dependent":
        mesh = M.create_unit_square(3, 3)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: (1.0 + c.x[0] * c.x[1]) * inner(grad(u), grad(v)))
    if name == "complex_constant":
        mesh = M.create_unit_square(3, 2)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: (1.0 + 0.5j) * inner(grad(u), grad(v))
                                         + 0.25j * u.value * F.conj(v.value))
    if name == "coefficient":
        mesh = M.create_unit_cube(2, 2, 2)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        w = _coefficient(pkg, V, lambda x: 1.0 + 0.5 * x[0] * x[1])
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: c["w"].value * inner(grad(u), grad(v)),
                                         coefficients={"w": w}, quad_degree=2)
    if name == "vector_coefficient":
        mesh = M.create_unit_square(2, 3)
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        W = pkg.functionspace(mesh, ("Lagrange", 1, (2,)))
        w = _coefficient(pkg, W, lambda x: np.stack([1.0 + x[0], 0.5 + x[1] ** 2]))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: (c["w"].value[0] + c["w"].gradient[1, 1])
                                         * inner(grad(u), grad(v)), coefficients={"w": w})
    # the refused ones: hexahedra (whose rules have 27 points or more), P2
    # tets at the default degree
    if name == "hex_q4":
        mesh = M.create_unit_cube(1, 1, 1, "hexahedron")
        V = pkg.functionspace(mesh, ("Lagrange", 1))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=4)
    if name == "p2_tet_default":
        mesh = M.create_unit_cube(1, 1, 1)
        V = pkg.functionspace(mesh, ("Lagrange", 2))
        return mesh, V, pkg.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    raise KeyError(name)


SUPPORTED = ["p1_tet", "p1_tet_mass", "p2_tet", "quad", "elasticity", "x_dependent", "complex_constant",
             "coefficient", "vector_coefficient"]
REFUSED = ["hex", "hex_q4", "p2_tet_default"]
DTYPES = {"f64": np.float64, "f32": np.float32, "c128": np.complex128, "c64": np.complex64}
TOL = {"f64": 1e-12, "c128": 1e-12, "f32": 5e-6, "c64": 5e-6}


def _kernels(name, dtype):
    mj, Vj, aj = _form(name, "jx")
    mp, Vp, ap = _form(name, "pt")
    return (mj, Vj, aj, jax_soa(mj, Vj, Vj, aj.terms[0], dtype)), (mp, Vp, ap, port_soa(mp, Vp, Vp, ap.terms[0], dtype))


@pytest.mark.parametrize("name", SUPPORTED + REFUSED)
def test_support_test_equals_jax(name):
    (mj, Vj, aj, kj), (mp, Vp, ap, kp) = _kernels(name, np.float64)
    assert (kj is not None) == (kp is not None) == (name in SUPPORTED)
    assert soa_supported(mp, Vp, Vp, ap.terms[0]) == (kp is not None)


@pytest.mark.parametrize("name", SUPPORTED)
def test_recovered_feature_matrix_equals_jax(name):
    """The structural nonzeros of M, and its values where M is constant,
    are the JAX package's: the same probes from the same generator."""
    (_, _, _, kj), (_, _, _, kp) = _kernels(name, np.float64)
    env = inspect.getclosurevars(kj).nonlocals
    assert kp.nz_pairs == env["nz_pairs"]
    if env["M_const"] is None:
        assert kp.M_const is None
    else:
        assert kp.M_const.keys() == env["M_const"].keys()
        for k, v in env["M_const"].items():
            assert kp.M_const[k] == v, k


def _soa_inputs(mesh, a, rdt):
    coords = mesh.points[mesh.cells].astype(rdt).transpose(1, 2, 0)
    wl = {}
    for n, fn in a.terms[0].coefficients.items():
        W = fn.function_space
        vals = np.asarray(fn.x.array)[W.dofmap]
        wl[n] = vals.reshape(-1, W.element.ndofs, W.block_size).transpose(1, 2, 0).astype(rdt)
    return coords, wl


# a complex integrand takes a complex dtype
CASES = [(name, dt) for name in SUPPORTED for dt in DTYPES if name != "complex_constant" or dt[0] == "c"]


@pytest.mark.parametrize("name,dt", CASES)
def test_element_tensors_equal_jax(name, dt):
    import jax.numpy as jnp

    dtype = DTYPES[dt]
    rdt = np.float32 if dt in ("f32", "c64") else np.float64
    (mj, _, aj, kj), (_, _, _, kp) = _kernels(name, dtype)
    coords, wl = _soa_inputs(mj, aj, rdt)
    Aj = np.asarray(kj(jnp.asarray(coords), {k: jnp.asarray(v) for k, v in wl.items()}))
    Ap = kp(torch.as_tensor(coords), {k: torch.as_tensor(v) for k, v in wl.items()}).numpy()
    assert Ap.shape == Aj.shape and Ap.dtype == Aj.dtype
    assert np.abs(Ap - Aj).max() <= TOL[dt] * np.abs(Aj).max()


def test_kernel_chunks_agree():
    """A kernel run chunk by chunk over the cells gives the tensors of one
    pass (the chunk bound of the card's 1.5M-cell runs, forced small)."""
    from dolfinx_mpc_tpu_torch.ops import soa_kernels

    mp, Vp, ap = _form("coefficient", "pt")
    coords, wl = _soa_inputs(mp, ap, np.float64)
    args = (torch.as_tensor(coords), {k: torch.as_tensor(v) for k, v in wl.items()})
    whole = port_soa(mp, Vp, Vp, ap.terms[0], np.float64)(*args)
    old = soa_kernels.SOA_CHUNK_VALUES
    try:
        soa_kernels.SOA_CHUNK_VALUES = 500  # a few cells per chunk
        parts = port_soa(mp, Vp, Vp, ap.terms[0], np.float64)(*args)
    finally:
        soa_kernels.SOA_CHUNK_VALUES = old
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("form", ["p1_tet", "coefficient", "quad"])
def test_lattice_forms_take_the_soa_kernel(form):
    """CompiledLatticeForm assembles with the SoA kernel wherever it
    exists, and its element tensors equal the cell-first kernel's."""
    mp, Vp, ap = _form(form, "pt")
    bdofs = pt.locate_dofs_geometrical(Vp, lambda x: np.isclose(x[1], 0.0))
    bc = pt.dirichletbc(0.0, bdofs, Vp)
    clf = pt.assemble_matrix_lattice(ap, None, bcs=[bc], side_format="csr", device="cpu")
    assert clf._soa_kernel is not None
    from dolfinx_mpc_tpu_torch.ops.assemble import _coeff_vectors

    wl = {k: _coeff_vectors(clf.term, "cpu")[k][dm] for k, dm in clf._wdofmaps.items()}
    soa = clf._element_tensors(clf._coords, wl)
    cf = clf._cell_first_tensors(clf._coords, wl)
    assert soa.shape == cf.shape
    assert float((soa - cf).abs().max()) <= 1e-12 * float(cf.abs().max())
