"""Element-tensor kernels: vectorize an integrand over (entities x
quadrature x basis functions) with ``torch.func.vmap``.

Counterpart of ``dolfinx_mpc_tpu/ops/kernels.py`` for cell and
exterior-facet integrals over Lagrange spaces, uniform or mixed.  The
geometry pullback is batched einsums; the integrand runs under nested vmaps
exactly as the JAX package runs it under ``jax.vmap``.  A facet integral
tabulates its bases and geometry once per local facet, at the facet
quadrature points mapped into the cell, and each facet takes its slice by
indexing with its local-facet index, field by field.

A mixed space (fem/mixed.py) is a list of fields; each local basis
function belongs to one field, its Arg for that field is the usual
value/gradient and ZERO for the others, and the integrand receives a tuple
of per-field Args — e.g. Stokes:
  lambda u, v, c: inner(grad(u[0]), grad(v[0])) - div(v[0]) * conj(u[1].value) - ...
A coefficient on a mixed space arrives as a tuple of per-field Args too.
For ordinary spaces the field list has length 1 and a bare Arg is passed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..fem.forms import Arg, Ctx, FormTerm
from ..fem.functionspace import FunctionSpace
from ..fem.geometry_maps import (
    facet_reference_points,
    facet_tangent_matrix,
    geom_tabulation,
    reference_facet_normals,
)
from ..fem.quadrature import quadrature_rule
from .smallmat import small_det, small_inv

__all__ = ["CompiledTerm", "compile_term"]


def _basis_args(phi, dphi_phys, bs):
    """Unrolled basis Arg arrays at all qps.

    phi: (nq, nd); dphi_phys: (nq, nd, gdim).
    Returns (values, gradients):
      bs == 1: values (nq, nd), gradients (nq, nd, gdim)
      bs > 1:  values (nq, nd*bs, bs), gradients (nq, nd*bs, bs, gdim)
    """
    if bs == 1:
        return phi, dphi_phys
    nq, nd = phi.shape
    eye = torch.eye(bs, dtype=phi.dtype, device=phi.device)
    vals = torch.einsum("qi,kb->qikb", phi, eye).reshape(nq, nd * bs, bs)
    grads = torch.einsum("qig,kb->qikbg", dphi_phys, eye).reshape(
        nq, nd * bs, bs, dphi_phys.shape[-1])
    return vals, grads


def _coeff_args(phi_w, dphi_w_phys, wlocal, bs):
    """Coefficient value/gradient at all qps from local dof values.

    wlocal: (nd_w*bs,) interleaved.  Returns Arg arrays over q."""
    nd = phi_w.shape[1]
    wl = wlocal.reshape(nd, bs)
    vals = torch.einsum("qi,ib->qb", phi_w, wl)
    grads = torch.einsum("qig,ib->qbg", dphi_w_phys, wl)
    if bs == 1:
        return vals[:, 0], grads[:, 0, :]
    return vals, grads


def _side_fields(V):
    """[(element, bs, slot_start)], total unrolled local dofs, is_mixed."""
    if getattr(V, "is_mixed", False):
        out, s0 = [], 0
        for W in V.spaces:
            out.append((W.element, W.block_size, s0))
            s0 += W.element.ndofs * W.block_size
        return out, s0, True
    return [(V.element, V.block_size, 0)], V.element.ndofs * V.block_size, False


class _Side:
    """Basis tables of one side (test, trial or a coefficient's space): per
    field (phi, dphi, bs, slot_start) as host arrays, the unrolled local
    dof count ND and whether the space is mixed."""

    def __init__(self, V, tabulate):
        fields, self.ND, self.mixed = _side_fields(V)
        self.fields = [(*tabulate(el), bs, s0) for el, bs, s0 in fields]

    def to(self, T, pick=None):
        """The tables as tensors (T converts), each sliced by `pick`."""
        pick = pick or (lambda a: a)
        return [(pick(T(p)), pick(T(d)), bs, s0) for p, d, bs, s0 in self.fields]


def _field_basis_args(tabs, Jinv, ND):
    """Per-field (values, grads) over q, padded with zeros to ND local-dof
    rows at the field's slot range.  Returns a tuple of (vals, grads)."""
    res = []
    for phi, dphi, bs, s0 in tabs:
        v, g = _basis_args(phi, torch.einsum("qit,qtg->qig", dphi, Jinv), bs)
        w = v.shape[1]
        if w != ND:
            pad = lambda a, k: a.new_zeros((a.shape[0], k) + tuple(a.shape[2:]))  # noqa: E731
            v = torch.cat([pad(v, s0), v, pad(v, ND - s0 - w)], dim=1)
            g = torch.cat([pad(g, s0), g, pad(g, ND - s0 - w)], dim=1)
        res.append((v, g))
    return tuple(res)


def _mk_arg(mixed):
    """Tuple of per-field (v, g) -> the integrand's argument (a tuple of
    Args, or a bare Arg)."""
    if mixed:
        return lambda t: tuple(Arg(*p) for p in t)
    return lambda t: Arg(*t[0])


def _coeffs(sides_w, tabs_w, Jinv, wlocals):
    """Coefficient (value, gradient) pairs over q by name, per field (a
    tuple of pairs for a mixed coefficient space), in the wider of the
    geometry's and the coefficient's dtypes (jnp.einsum's promotion).
    sides_w and tabs_w map each name to its _Side and its field tables."""
    out = {}
    for name, tabs in tabs_w.items():
        side, wl = sides_w[name], wlocals[name]
        parts = []
        for p, d, bs, s0 in tabs:
            dt = torch.promote_types(p.dtype, wl.dtype)
            dwp = torch.einsum("qit,qtg->qig", d, Jinv).to(dt)
            nd = p.shape[1]
            parts.append(_coeff_args(p.to(dt), dwp, wl[s0:s0 + nd * bs].to(dt), bs))
        out[name] = tuple(parts) if side.mixed else parts[0]
    return out


@dataclass
class CompiledTerm:
    """A single integral term compiled to a batched element-tensor function.

    kernel(coords, lf, wlocals) -> Ae:
      coords: (n_ent, n_verts, gdim) tensor
      lf: (n_ent,) int64 local facet index of each facet on coords' device
          (facet integrals; cell kernels ignore it)
      wlocals: dict name -> (n_ent, nd_w*bs_w) local coefficient values
      Ae: (n_ent, ndt[, nds]) element tensors (quadrature weights and
      |detJ| / surface measure included), on coords' device and dtype.
    """

    term: FormTerm
    entities: np.ndarray  # active cells (cell integral) or facets
    cells: np.ndarray  # cell of each active entity
    local_facets: np.ndarray  # per active entity (zeros for cell integrals)
    kernel: Callable
    coeff_names: tuple
    coeff_spaces: tuple


def compile_term(term: FormTerm, V_test: FunctionSpace, V_trial: Optional[FunctionSpace]) -> CompiledTerm:
    mesh = V_test.mesh
    rank = 2 if V_trial is not None else 1
    deg_t = V_test.element.degree
    deg_s = V_trial.element.degree if V_trial is not None else deg_t
    qdeg = term.quad_degree
    if qdeg is None:
        qdeg = deg_t + deg_s + max(deg_t, deg_s)  # headroom for coefficients/coords
    coeff_names = tuple(term.coefficients.keys())
    coeff_spaces = tuple(term.coefficients[n].function_space for n in coeff_names)
    args = (mesh, V_test, V_trial, term.integrand, qdeg, coeff_names, coeff_spaces, term.constants, rank)

    if term.integral == "cell":
        cells = (
            np.arange(mesh.num_cells, dtype=np.int32)
            if term.entities is None
            else np.asarray(term.entities, dtype=np.int32)
        )
        return CompiledTerm(term, cells, cells, np.zeros(len(cells), np.int32), _make_cell_kernel(*args),
                            coeff_names, coeff_spaces)

    if term.integral == "exterior_facet":
        facets = (
            mesh.exterior_facets() if term.entities is None else np.asarray(term.entities, dtype=np.int32)
        )
        _, cell_to_f, f2c = mesh.facets()
        cells = f2c[facets, 0]
        # local facet index of each facet within its cell
        lf = np.argmax(cell_to_f[cells] == facets[:, None], axis=1).astype(np.int32)
        return CompiledTerm(term, facets, cells.astype(np.int32), lf, _make_facet_kernel(*args),
                            coeff_names, coeff_spaces)

    raise ValueError(f"unsupported integral type {term.integral}")


def _element_tensor(integrand, rank, sides, targs, sargs, xq, normal, wargs, consts, scale):
    """One entity's element tensor from its per-field basis pairs over q
    (test, and trial for rank 2), its quadrature points, facet normals
    (None for cells), coefficient pairs and the per-point scale.  `sides`
    holds the test side, the trial side (or None) and, by name, the
    coefficients' sides (which say whether each is mixed)."""
    vmap = torch.func.vmap
    with_n = normal is not None
    side_t, side_s, sides_w = sides
    mk_t = _mk_arg(side_t.mixed)

    def ctx_at(x_q, n_q, w_q):
        wd = {n: (tuple(Arg(*p) for p in a) if sides_w[n].mixed else Arg(*a)) for n, a in w_q.items()}
        return Ctx(x_q, n_q, {**wd, **consts})

    if rank == 1:
        def at_q(t_q, x_q, n_q, w_q):
            ctx = ctx_at(x_q, n_q, w_q)
            return vmap(lambda vt: integrand(mk_t(vt), ctx))(t_q)

        vals = vmap(at_q, in_dims=(0, 0, 0 if with_n else None, 0))(targs, xq, normal, wargs)
        return torch.einsum("q,qi->i", scale.to(vals.dtype), vals)

    mk_s = _mk_arg(side_s.mixed)

    def at_q(t_q, s_q, x_q, n_q, w_q):
        ctx = ctx_at(x_q, n_q, w_q)

        def row(vt):  # one test function
            return vmap(lambda ut: integrand(mk_s(ut), mk_t(vt), ctx))(s_q)

        return vmap(row)(t_q)  # (ndt, nds)

    vals = vmap(at_q, in_dims=(0, 0, 0, 0 if with_n else None, 0))(targs, sargs, xq, normal, wargs)
    return torch.einsum("q,qij->ij", scale.to(vals.dtype), vals)


def _converter(dev, rdt):
    """numpy -> tensor of the coordinates' device and real dtype."""
    return lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=dev)


def _consts(constants, T):
    return {k: (v if isinstance(v, (int, float, complex)) else T(v)) for k, v in constants.items()}


def _make_cell_kernel(mesh, V_test, V_trial, integrand, qdeg, coeff_names, coeff_spaces, constants, rank):
    """Batched element kernel: the geometry per cell and the basis data per
    quadrature point are tensors; the integrand is vmapped over (q, i[, j])
    inside a vmap over cells."""
    q, w = quadrature_rule(mesh.ref_cell, qdeg)
    phi_g, dphi_g = geom_tabulation(mesh.cell_type, q)  # (nq, nv), (nq, nv, tdim)
    tabulate = lambda el: (el.tabulate(q), el.tabulate_grad(q))  # noqa: E731
    side_t = _Side(V_test, tabulate)
    side_s = None if rank == 1 else _Side(V_trial, tabulate)
    sides_w = {n: _Side(W, tabulate) for n, W in zip(coeff_names, coeff_spaces)}
    sides = (side_t, side_s, sides_w)

    def kernel(coords_b, lf_unused, wlocals_b):
        T = _converter(coords_b.device, coords_b.dtype)
        phi_gt, dphi_gt, wq = T(phi_g), T(dphi_g), T(w)
        tt = side_t.to(T)
        ts = None if side_s is None else side_s.to(T)
        tw = {n: side.to(T) for n, side in sides_w.items()}
        consts = _consts(constants, T)

        def kernel_one(coords, wlocals):
            J = torch.einsum("qvt,vg->qgt", dphi_gt, coords)  # (nq, gdim, tdim)
            detJ = small_det(J)
            Jinv = small_inv(J)  # (nq, tdim, gdim)
            xq = phi_gt @ coords  # (nq, gdim)
            scale = wq * torch.abs(detJ)
            sargs = None if ts is None else _field_basis_args(ts, Jinv, side_s.ND)
            return _element_tensor(integrand, rank, sides, _field_basis_args(tt, Jinv, side_t.ND), sargs, xq,
                                   None, _coeffs(sides_w, tw, Jinv, wlocals), consts, scale)

        return torch.func.vmap(kernel_one)(coords_b, wlocals_b)

    return kernel


def _make_facet_kernel(mesh, V_test, V_trial, integrand, qdeg, coeff_names, coeff_spaces, constants, rank):
    """Batched exterior-facet kernel: bases and geometry tabulated once per
    local facet (stacked on a leading local-facet axis), each facet's slice
    gathered by its local-facet index, field by field, then the outward
    normal J^{-T} N / |J^{-T} N| and the Nanson measure w |detJ| |J^{-T} N|
    times the facet's reference embedding.  J^{-T} N is outward whatever
    the sign of detJ (its dot product with J dX is N . dX); the JAX package
    also multiplies the normal by sign(detJ), which turns it inward on
    negatively oriented cells (half the tets of create_box), a defect the
    port does not copy (ROADMAP queue 3)."""
    cell_type = mesh.cell_type
    cell = mesh.ref_cell
    qf, wf = quadrature_rule(cell.facet_cell, qdeg)
    n_lf = len(cell.facets)
    Xq = [facet_reference_points(cell_type, k, qf) for k in range(n_lf)]
    # per field: (phi (n_lf, nq, nd), dphi (n_lf, nq, nd, tdim))
    tabulate = lambda el: (np.stack([el.tabulate(X) for X in Xq]),  # noqa: E731
                           np.stack([el.tabulate_grad(X) for X in Xq]))
    geo = [geom_tabulation(cell_type, X) for X in Xq]
    phi_g = np.stack([g[0] for g in geo])  # (n_lf, nq, nv)
    dphi_g = np.stack([g[1] for g in geo])  # (n_lf, nq, nv, tdim)
    embed = []
    for k in range(n_lf):
        Tm = facet_tangent_matrix(cell_type, k)
        embed.append(np.sqrt(np.linalg.det(Tm.T @ Tm)) if Tm.size else 1.0)
    embed = np.asarray(embed)
    ref_normals = reference_facet_normals(cell_type)  # (n_lf, tdim)
    side_t = _Side(V_test, tabulate)
    side_s = None if rank == 1 else _Side(V_trial, tabulate)
    sides_w = {n: _Side(W, tabulate) for n, W in zip(coeff_names, coeff_spaces)}
    sides = (side_t, side_s, sides_w)

    def kernel(coords_b, lf_b, wlocals_b):
        T = _converter(coords_b.device, coords_b.dtype)
        lf_b = lf_b.to(device=coords_b.device, dtype=torch.int64)
        at = lambda a: a[lf_b]  # noqa: E731  (n_ent, ...) slices of a local-facet stack
        geo_b = (at(T(phi_g)), at(T(dphi_g)), at(T(ref_normals)), at(T(embed)))
        # the batched inputs: per side, per field (phi, dphi) of each facet
        pairs = lambda side: [(p, d) for p, d, _, _ in side.to(T, at)]  # noqa: E731
        tabs_b = {"t": pairs(side_t), "w": {n: pairs(side) for n, side in sides_w.items()}}
        if side_s is not None:
            tabs_b["s"] = pairs(side_s)
        wq = T(wf)
        consts = _consts(constants, T)
        with_meta = lambda side, ps: [(p, d, bs, s0) for (p, d), (_, _, bs, s0) in zip(ps, side.fields)]  # noqa: E731

        def kernel_one(coords, geo, tabs, wlocals):
            pg, dg, nref, emb = geo
            J = torch.einsum("qvt,vg->qgt", dg, coords)
            detJ = small_det(J)
            Jinv = small_inv(J)
            xq = pg @ coords
            # Nanson: ds = |detJ| |J^{-T} N| dS_ref; the measure includes the embedding
            nvec = torch.einsum("qtg,t->qg", Jinv, nref)  # J^{-T} N, outward
            nnorm = torch.linalg.vector_norm(nvec, dim=1)
            normal = nvec / nnorm[:, None]
            scale = wq * torch.abs(detJ) * nnorm * emb
            targs = _field_basis_args(with_meta(side_t, tabs["t"]), Jinv, side_t.ND)
            sargs = (None if side_s is None
                     else _field_basis_args(with_meta(side_s, tabs["s"]), Jinv, side_s.ND))
            tw = {n: with_meta(sides_w[n], p) for n, p in tabs["w"].items()}
            return _element_tensor(integrand, rank, sides, targs, sargs, xq, normal,
                                   _coeffs(sides_w, tw, Jinv, wlocals), consts, scale)

        return torch.func.vmap(kernel_one)(coords_b, geo_b, tabs_b, wlocals_b)

    return kernel
