"""Variational forms: a "UFL-lite" over per-quadrature-point basis data.

Counterpart of ``dolfinx_mpc_tpu/fem/forms.py``.  A form's integrand is an
ordinary Python function over basis data (`Arg`) and a context (`Ctx`).  The
element kernels (ops/kernels.py) call it under ``torch.func.vmap`` over
(cells x quadrature points x basis functions); the lattice assembler's
constant-coefficient probe (ops/lattice_kernels.py:_probe_constant_M) calls
it with numpy probes.  The operators below therefore take torch tensors and
numpy arrays alike.

Example::

    a = BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)))
    L = LinearForm(V, lambda v, c: 4.0 * v.value)

``derivative`` turns a residual form into its Jacobian form by forward-mode
AD (``torch.func.jvp``) on the coefficient's value and gradient at each
quadrature point.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from .functionspace import FunctionSpace

__all__ = [
    "Arg",
    "Ctx",
    "BilinearForm",
    "LinearForm",
    "Form",
    "FormTerm",
    "derivative",
    "grad",
    "div",
    "sym",
    "tr",
    "inner",
    "dot",
    "outer",
    "Identity",
    "conj",
]


class Arg:
    """Basis-function (or coefficient) data at one quadrature point.

    For a scalar space: value is a scalar, gradient has shape (gdim,).
    For a blocked space (bs>1): value has shape (bs,), gradient (bs, gdim).
    """

    def __init__(self, value, gradient):
        self.value = value
        self.gradient = gradient

    # ufl-ish sugar
    @property
    def dx(self):
        return self.gradient


class Ctx:
    """Per-quadrature-point context: physical coordinate x, facet normal n
    (exterior-facet integrals only), and coefficient Args by name."""

    def __init__(self, x, n=None, w=None):
        self.x = x
        self.n = n
        self.w = {} if w is None else w

    def __getitem__(self, name):
        return self.w[name]


# ---- tensor calculus helpers (torch tensors or numpy arrays) --------------


def _val(a):
    return a.value if isinstance(a, Arg) else a


def _pair(a, b):
    """Values of two operands, an Identity made dense like the other."""
    a, b = _val(a), _val(b)
    if isinstance(a, _Identity):
        a = a.dense(b)
    if isinstance(b, _Identity):
        b = b.dense(a)
    return a, b


def _is_torch(*xs):
    return any(isinstance(x, torch.Tensor) for x in xs)


def grad(u):
    return u.gradient if isinstance(u, Arg) else u


def div(u):
    g = grad(u)
    if _is_torch(g):
        return torch.diagonal(g).sum() if g.ndim == 2 else g.sum()
    g = np.asarray(g)
    return np.trace(g) if g.ndim == 2 else np.sum(g)


def sym(A):
    return 0.5 * (A + (A.mT if _is_torch(A) else A.T))


def tr(A):
    if isinstance(A, _Identity):
        return A.scale * A.n
    return torch.diagonal(A).sum() if _is_torch(A) else np.trace(A)


def conj(a):
    return torch.conj(a) if _is_torch(a) else np.conj(a)


def inner(a, b):
    """Frobenius inner product; conjugates the SECOND argument (test side),
    matching UFL's convention so complex assembly gives sesquilinear forms."""
    a, b = _pair(a, b)
    if _is_torch(a, b):
        return (a * conj(b)).sum()
    return np.sum(np.asarray(a) * np.conj(np.asarray(b)))


def dot(a, b):
    a, b = _pair(a, b)
    if _is_torch(a, b):
        if not (_is_torch(a) and _is_torch(b)) or a.ndim == 0 or b.ndim == 0:
            return a * b
        if a.ndim == 1 and b.ndim == 1:
            return (a * b).sum()
        return a @ b
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == 1 and b.ndim == 1:
        return np.sum(a * b)
    return a @ b


def outer(a, b):
    a, b = _pair(a, b)
    if _is_torch(a, b):
        return a[:, None] * conj(b)[None, :]
    return np.outer(np.asarray(a), np.conj(np.asarray(b)))


class _Identity:
    """scale * I_n, kept symbolic until it meets a tensor or an array: the
    integrand runs under vmap on the kernel's device and dtype, which a
    factory call inside the integrand cannot see, so the identity takes
    both from the operand it is combined with."""

    __array_ufunc__ = None  # numpy defers to the reflected operators below

    def __init__(self, n, scale=1.0):
        self.n = n
        self.scale = scale.item() if isinstance(scale, np.generic) else scale

    def dense(self, like=None):
        if isinstance(like, torch.Tensor):
            return self.scale * torch.eye(self.n, dtype=like.dtype, device=like.device)
        return self.scale * np.eye(self.n)

    def _combine(self, other, op):
        if isinstance(other, _Identity):
            return _Identity(self.n, op(self.scale, other.scale))
        return op(self.dense(other), other)

    def __mul__(self, other):
        if isinstance(other, (int, float, complex)):
            return _Identity(self.n, self.scale * other)
        return self.dense(other) * other

    __rmul__ = __mul__

    def __neg__(self):
        return _Identity(self.n, -self.scale)

    def __add__(self, other):
        return self._combine(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._combine(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._combine(other, lambda a, b: b - a)


def Identity(n):
    return _Identity(n)


# ---- form containers -----------------------------------------------------


@dataclass
class FormTerm:
    integrand: Callable
    integral: str = "cell"  # "cell" | "exterior_facet"
    entities: Optional[np.ndarray] = None  # cells or facet indices; None = all
    coefficients: dict = field(default_factory=dict)  # name -> Function
    constants: dict = field(default_factory=dict)  # name -> scalar/array
    quad_degree: Optional[int] = None


@dataclass
class Form:
    """rank 2 (bilinear) or rank 1 (linear) form as a sum of integral terms."""

    test_space: FunctionSpace
    trial_space: Optional[FunctionSpace]
    terms: list

    @property
    def rank(self) -> int:
        return 2 if self.trial_space is not None else 1

    @property
    def function_spaces(self):
        return (
            [self.test_space, self.trial_space]
            if self.trial_space is not None
            else [self.test_space]
        )

    def __add__(self, other: "Form") -> "Form":
        assert other.test_space is self.test_space
        return Form(self.test_space, self.trial_space, self.terms + other.terms)


def BilinearForm(
    V,
    integrand,
    V_trial=None,
    integral="cell",
    entities=None,
    coefficients=None,
    constants=None,
    quad_degree=None,
) -> Form:
    """a(u, v): integrand(u, v, ctx) -> scalar.  V is the test space; trial
    defaults to the same space (rectangular forms pass V_trial)."""
    term = FormTerm(
        integrand,
        integral,
        None if entities is None else np.asarray(entities),
        coefficients or {},
        constants or {},
        quad_degree,
    )
    return Form(V, V_trial if V_trial is not None else V, [term])


def LinearForm(
    V,
    integrand,
    integral="cell",
    entities=None,
    coefficients=None,
    constants=None,
    quad_degree=None,
) -> Form:
    """L(v): integrand(v, ctx) -> scalar."""
    term = FormTerm(
        integrand,
        integral,
        None if entities is None else np.asarray(entities),
        coefficients or {},
        constants or {},
        quad_degree,
    )
    return Form(V, None, [term])


def _arg_leaves(a):
    """The tensors of an Arg, or of a tuple of Args (a mixed-space
    coefficient), in order."""
    if isinstance(a, Arg):
        return [a.value, a.gradient]
    return [t for x in a for t in _arg_leaves(x)]


def _arg_rebuild(like, leaves):
    """An Arg (or tuple of Args) shaped like `like` from its tensors."""
    if isinstance(like, Arg):
        return Arg(leaves[0], leaves[1]), leaves[2:]
    out = []
    for x in like:
        a, leaves = _arg_rebuild(x, leaves)
        out.append(a)
    return tuple(out), leaves


def derivative(F: Form, u_name: str) -> Form:
    """Gateaux derivative of a residual form w.r.t. the coefficient named
    `u_name`: the Jacobian bilinear form, by forward-mode AD
    (``torch.func.jvp``) on the coefficient's value and gradient at each
    quadrature point, inside the element kernel's vmaps.  Replaces
    ``ufl.derivative`` in the nonlinear drivers."""
    assert F.rank == 1
    terms = []
    for t in F.terms:
        if u_name not in t.coefficients:
            continue

        def make(jt):
            def jac_integrand(du, v, ctx):
                # d/deps integrand(v, ctx with w[u] -> w[u] + eps*du)
                u0 = ctx.w[u_name]

                def f(*leaves):
                    w = dict(ctx.w)
                    w[u_name] = _arg_rebuild(u0, list(leaves))[0]
                    return jt.integrand(v, Ctx(ctx.x, ctx.n, w))

                primals = tuple(_arg_leaves(u0))
                tangents = tuple(d.to(p.dtype) for d, p in zip(_arg_leaves(du), primals))
                return torch.func.jvp(f, primals, tangents)[1]

            return jac_integrand

        terms.append(FormTerm(make(t), t.integral, t.entities, dict(t.coefficients), dict(t.constants),
                              t.quad_degree))
    V = F.terms[0].coefficients[u_name].function_space
    return Form(F.test_space, V, terms)
