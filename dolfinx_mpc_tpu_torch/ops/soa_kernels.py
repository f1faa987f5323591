"""Structure-of-arrays (cells-last) element kernels by bilinearity probing.

Counterpart of ``dolfinx_mpc_tpu/ops/soa_kernels.py``.  A bilinear
integrand is a quadratic form in the basis features F(u) = [value,
physical-gradient components] of each component:

    f(u, v, ctx) = F(u)^T . M(x, w) . F(v)

so the kernel (a) probes the integrand once with unit features to recover
M — at compile time when M is constant, else vmapped over the cells of
each quadrature point, so x- and coefficient-dependent entries come out as
(c,) tensors — and (b) accumulates

    Ae[i, j] = sum_q w_q |detJ_q| sum_{s,t} M_q[s,t] . F_i[s] . F_j[t]

with every run-time tensor of shape (..., c): cells last, so the card's
loads of one entry over consecutive cells are coalesced.  Structurally zero
M entries are found with concrete random probes drawn from
``np.random.default_rng(1234)`` in the JAX package's order, so both
packages elide the same entries; Poisson costs g^2 terms per (i, j, q),
not (1+g)^2.

Where the JAX package unrolls every (q, s, t, i, j) term into its trace,
the sum here is a few batched tensor operations per quadrature point: for
each row feature s the row H_s = sum_t M[s,t] F[t] over all (j, c) at
once, scaled by w_q |detJ_q|, then one multiply-add of F[s] (x) H_s into
the (i, ki, j, kj, c) accumulator.  Where the features and M do not change
between quadrature points (affine geometry, constant M, gradient features
of a degree-1 element), the points collapse into one pass with their
weights summed.  Plain torch, any device: the JAX module is XLA code, not
a Pallas kernel.  At 1.5M cells every launch here moves tens of MB, so the
bytes per entry set the time, not the launch count: a dense row table
summed by one GEMM, or the entries' products summed into their rows by a
0/1 selection GEMM, were both 1.2-1.6x slower on a coefficient form and
no faster on P1 elasticity (NVIDIA H100, scripts/soa_times.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.forms import Arg, Ctx, FormTerm
from ..fem.geometry_maps import geom_tabulation
from ..fem.quadrature import quadrature_rule

__all__ = ["compile_cell_kernel_soa", "soa_supported"]

# values held per cell by one chunk of the kernel's work (accumulator,
# features, rows H, geometry): bounds its working set
SOA_CHUNK_VALUES = 2 ** 27


def _unit_features(bs, g, dtype=np.float64):
    """Probe Args: one per feature (component k, then value + g gradient
    entries).  Feature index layout: alpha = k*(1+g) + (0 for value, 1+t)."""
    probes = []
    for k in range(bs):
        val = np.zeros(bs, dtype)
        val[k] = 1.0
        probes.append(Arg(val[0] if bs == 1 else val, np.zeros((bs, g) if bs > 1 else g, dtype)))
        for t in range(g):
            gr = np.zeros((bs, g), dtype)
            gr[k, t] = 1.0
            probes.append(Arg(np.zeros(bs, dtype)[0] if bs == 1 else np.zeros(bs, dtype), gr[0] if bs == 1 else gr))
    return probes


def _soa_degree(term, degree):
    return term.quad_degree if term.quad_degree is not None else 2 * degree


def soa_supported(mesh, V_test, V_trial, term: FormTerm) -> bool:
    """The JAX package's support test (soa_kernels.py:59-88): a cell
    integral of a square form on one uniform space with gdim == tdim, and at
    most 10,000 unrolled terms nq * nd^2 * bs^2 * (1 + gdim)^2 at the
    term's quadrature degree, else 2 * degree."""
    if term.integral != "cell" or V_trial is None or V_trial is not V_test:
        return False
    if getattr(V_test, "is_mixed", False) or mesh.gdim != mesh.ref_cell.tdim:
        return False
    el, bs, g = V_test.element, V_test.block_size, mesh.gdim
    nq = len(quadrature_rule(mesh.ref_cell, _soa_degree(term, el.degree))[1])
    return nq * el.ndofs ** 2 * bs ** 2 * (1 + g) ** 2 <= 10_000


def compile_cell_kernel_soa(mesh, V_test, V_trial, term: FormTerm, dtype):
    """Build kernel(coords_soa (nv, g, c), wl_soa {name: (nd_w, bs_w, c)})
    -> Ae (nd*bs, nd*bs, c), or return None where soa_supported is False.
    Ae's dtype is the complex `dtype` for a complex dtype, else the
    coordinates' dtype."""
    if not soa_supported(mesh, V_test, V_trial, term):
        return None
    V = V_test
    cell = mesh.ref_cell
    g = mesh.gdim
    bs = V.block_size
    el = V.element
    q, w = quadrature_rule(cell, _soa_degree(term, el.degree))
    nq = len(w)
    nd_s = el.ndofs
    nF = 1 + g  # per-component features
    phi_g, dphi_g = geom_tabulation(mesh.cell_type, q)  # (nq, nv), (nq, nv, tdim)
    phi_t = el.tabulate(q)  # (nq, nd_s)
    dphi_t = el.tabulate_grad(q)  # (nq, nd_s, tdim)
    nv = phi_g.shape[1]
    probes = _unit_features(bs, g)
    nFb = bs * nF
    coeff_names = tuple(term.coefficients.keys())
    coeff_spaces = tuple(term.coefficients[n].function_space for n in coeff_names)
    coeff_tabs = [(W.element.tabulate(q), W.element.tabulate_grad(q), W.block_size) for W in coeff_spaces]
    np_consts = {k: np.asarray(v) for k, v in term.constants.items()}

    # ---- structural-zero detection with concrete random evaluations ------
    rng = np.random.default_rng(1234)

    def concrete_M(xpt, wv):
        ctx = Ctx(xpt, None, {**wv, **np_consts})
        out = np.zeros((nFb, nFb), np.complex128)
        for a in range(nFb):
            for b in range(nFb):
                out[a, b] = complex(np.asarray(term.integrand(probes[a], probes[b], ctx)))
        return out

    nonzero = np.zeros((nFb, nFb), bool)
    for _ in range(3):
        xpt = rng.random(g)
        wv = {}
        for n, (pw, dw, bw) in zip(coeff_names, coeff_tabs):
            val = rng.random(bw)
            grd = rng.random((bw, g))
            wv[n] = Arg(val[0] if bw == 1 else val, grd[0] if bw == 1 else grd)
        nonzero |= np.abs(concrete_M(xpt, wv)) > 0
    nz_pairs = [(a, b) for a in range(nFb) for b in range(nFb) if nonzero[a, b]]
    x_dependent = _probe_x_dependence(term, probes, nz_pairs, coeff_names, coeff_tabs, g, rng)
    M_const = None
    if not x_dependent:
        ctx0 = Ctx(np.zeros(g), None, dict(np_consts))
        M_const = {}
        for a, b in nz_pairs:
            val = complex(np.asarray(term.integrand(probes[a], probes[b], ctx0)))
            M_const[(a, b)] = val.real if val.imag == 0 else val

    rows = sorted({a for a, _ in nz_pairs})  # the row features that carry a term
    feats = sorted({a for a, _ in nz_pairs} | {b for _, b in nz_pairs})
    affine = bool((dphi_g == dphi_g[0]).all())  # one Jacobian for every point
    # the points collapse when neither M nor any feature changes between them
    collapse = (M_const is not None and affine and bool((dphi_t == dphi_t[0]).all())
                and all(f % nF != 0 for f in feats))
    nd = nd_s * bs
    per_cell = nd * nd + (nF + len(rows) * bs) * nd_s + 3 * g * g + nv * g
    chunk_cells = max(1, SOA_CHUNK_VALUES // per_cell)

    def chunk_kernel(X, wl_soa, out_dt):
        c_len = X.shape[-1]
        dev, rdt = X.device, X.dtype
        T = lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=dev)  # noqa: E731
        cdt = torch.promote_types(rdt, torch.complex64) if out_dt.is_complex else rdt
        Ae = torch.zeros((nd_s, bs, nd_s, bs, c_len), dtype=out_dt, device=dev)
        geo = None
        for iq in range(1 if collapse else nq):
            if geo is None or not affine:
                # J[a][b] = dx_a/dX_b as (c,) tensors
                J = torch.einsum("vb,vac->abc", T(dphi_g[iq]), X)
                det, inv = _soa_inv([[J[a, b] for b in range(g)] for a in range(g)])
                inv_t = torch.stack([torch.stack(r) for r in inv])  # (g, g, c)
                geo = (torch.abs(det), inv_t)
            adet, inv_t = geo
            wq = float(np.sum(w)) if collapse else float(w[iq])
            # physical gradients of the basis: G[i, a] = sum_t dref[i, t] inv[t][a]
            G = torch.einsum("it,tac->iac", T(dphi_t[iq]), inv_t)  # (nd_s, g, c)
            # per-component features f[s] (nd_s, c): value, then gradients
            f = [T(phi_t[iq])[:, None].expand(nd_s, c_len)] + [G[:, s] for s in range(g)]
            if M_const is not None:
                Mq = M_const
            else:
                xq = torch.einsum("v,vac->ac", T(phi_g[iq]), X)  # (g, c)
                wv_soa = {}
                for n, (pw, dw, bw) in zip(coeff_names, coeff_tabs):
                    wl = wl_soa[n]  # (nd_w, bs_w, c)
                    val = torch.einsum("i,ibc->bc", T(pw[iq]).to(wl.dtype), wl)
                    dref = torch.einsum("it,ibc->btc", T(dw[iq]).to(wl.dtype), wl)
                    grd = torch.einsum("btc,tac->bac", dref, inv_t.to(wl.dtype))  # (bs_w, g, c)
                    wv_soa[n] = (val, grd, bw)
                Mq = _probe_M(term, probes, nz_pairs, xq, wv_soa, coeff_names, rdt)
            scale = wq * adet
            for a in rows:
                ki, s = divmod(a, nF)
                # H[j, kj, c] = w |detJ| sum_t M[a, t] F_j[t]
                H = None
                for a2, b in nz_pairs:
                    if a2 != a:
                        continue
                    kj, t = divmod(b, nF)
                    m = Mq[(a, b)]
                    if H is None:
                        H = torch.zeros((nd_s, bs, c_len), dtype=cdt if _is_complex(m) else out_dt, device=dev)
                    if _is_complex(m) and not H.dtype.is_complex:
                        H = H.to(cdt)
                    H[:, kj] += m * f[t]
                H = (H * scale).to(out_dt)
                Ae[:, ki].addcmul_(f[s].to(out_dt)[:, None, None, :], H[None])
        return Ae.reshape(nd, nd, c_len)

    def kernel(coords_soa, wl_soa):
        """coords_soa: (nv, g, c); wl_soa: dict name -> (nd_w, bs_w, c)."""
        c_len = coords_soa.shape[-1]
        out_dt = coords_soa.dtype
        if np.dtype(dtype).kind == "c":
            out_dt = torch.promote_types(out_dt, torch.complex64)
        if c_len <= chunk_cells:
            return chunk_kernel(coords_soa, wl_soa, out_dt)
        out = torch.empty((nd, nd, c_len), dtype=out_dt, device=coords_soa.device)
        for lo in range(0, c_len, chunk_cells):
            hi = min(lo + chunk_cells, c_len)
            out[:, :, lo:hi] = chunk_kernel(coords_soa[..., lo:hi], {n: v[..., lo:hi] for n, v in wl_soa.items()},
                                            out_dt)
        return out

    # the recovered feature matrix: its structurally nonzero (row, col)
    # features and, where it does not depend on x or a coefficient, its values
    kernel.nz_pairs, kernel.M_const = nz_pairs, M_const
    return kernel


def _is_complex(m):
    return m.is_complex() if isinstance(m, torch.Tensor) else isinstance(m, complex)


def _soa_inv(J):
    """det and inverse of a small matrix given as nested lists of (c,) arrays."""
    g = len(J)
    if g == 1:
        det = J[0][0]
        return det, [[1.0 / det]]
    if g == 2:
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        return det, [
            [J[1][1] / det, -J[0][1] / det],
            [-J[1][0] / det, J[0][0] / det],
        ]
    a, b, c = J[0]
    d, e, f = J[1]
    gg, h, i = J[2]
    A = e * i - f * h
    B = f * gg - d * i
    C = d * h - e * gg
    det = a * A + b * B + c * C
    inv = [
        [A / det, (c * h - b * i) / det, (b * f - c * e) / det],
        [B / det, (a * i - c * gg) / det, (c * d - a * f) / det],
        [C / det, (b * gg - a * h) / det, (a * e - b * d) / det],
    ]
    return det, inv


def _probe_x_dependence(term, probes, nz_pairs, coeff_names, coeff_tabs, g, rng):
    """Is any nonzero M entry x- or coefficient-dependent?  If not, entries
    are compile-time constants and the vmapped probe is skipped entirely."""
    if coeff_names:
        return True
    vals = []
    for _ in range(2):
        xpt = rng.random(g)
        ctx = Ctx(xpt, None, {k: np.asarray(v) for k, v in term.constants.items()})
        vals.append(np.array([complex(np.asarray(term.integrand(probes[a], probes[b], ctx))) for a, b in nz_pairs]))
    return not np.allclose(vals[0], vals[1], rtol=1e-12, atol=1e-14)


def _probe_M(term, probes, nz_pairs, xq, wv_soa, coeff_names, rdt):
    """x-/coefficient-dependent M entries as (c,) tensors, by one vmap over
    the cell axis; the unit probes are tensors of the real dtype rdt on the
    points' device."""
    dev = xq.device
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=rdt, device=dev)  # noqa: E731
    tprobes = [Arg(T(p.value), T(p.gradient)) for p in probes]
    constants = {k: (v if isinstance(v, (int, float, complex)) else T(v)) for k, v in term.constants.items()}

    def all_entries(x_pt, wvals):
        wd = {}
        for n in coeff_names:
            val, grd = wvals[n]
            bw = wv_soa[n][2]
            wd[n] = Arg(val[0] if bw == 1 else val, grd[0] if bw == 1 else grd)
        ctx = Ctx(x_pt, None, {**wd, **constants})
        ents = [torch.as_tensor(term.integrand(tprobes[a], tprobes[b], ctx), device=dev) for a, b in nz_pairs]
        dt = rdt
        for e in ents:
            dt = torch.promote_types(dt, e.dtype)
        return torch.stack([e.to(dt) for e in ents])

    wv_in = {n: (wv_soa[n][0], wv_soa[n][1]) for n in coeff_names}
    vals = torch.func.vmap(all_entries, in_dims=(-1, {n: (-1, -1) for n in coeff_names}), out_dims=0)(xq, wv_in)
    return {ab: vals[:, k] for k, ab in enumerate(nz_pairs)}
