"""The lattice fast path's hand-written Hopper kernels, their plain PyTorch
versions and the host reduction that feeds the assemblers.

Counterpart of ``dolfinx_mpc_tpu/ops/pallas_lattice.py``:

- **K1** ``assemble_fold_lean_factored`` replaces the factored-mask fused
  lean-fold assembler (``_make_lean_fold_pallas_group`` -> ``kernel_factored``,
  entry ``make_lean_fold_pallas(fuse_mask=True)``) on the vertex grid.
- **K2** ``dia_matvec`` replaces the scalar DIA SpMV
  (``_make_dia_matvec_group``, entry ``make_dia_matvec_pallas``);
  ``DiaMatvecLaunch`` is its launch prepared once per operator.
- **K3** ``assemble_fold_lean_masked`` replaces the non-separable-mask
  variant (``kernel_masked``, fuse mode "2d"), on both layouts.
- **K4** ``assemble_fold_lean_blocked`` replaces the degree-2 blocked
  assembler (``make_lean_blocked_pallas``: K1's code over ``_BlockedView``);
  it launches K1's device code on the blocked table.
- **K5** ``assemble_fold_lean_raw`` replaces the unmasked assembler
  (``kernel``, fuse mode None) of forms without Dirichlet dofs, on the
  vertex grid, the blocked class grids and the refined degree-2 grid.
- **K6** ``blocked_matvec`` replaces the parity-blocked SpMV
  (``make_blocked_matvec_pallas``); ``BlockedMatvecLaunch`` is its launch
  prepared once per operator.
- **K7** ``dia_matvec_bs`` replaces the vector (bs > 1) DIA SpMV
  (``make_dia_matvec_bs_pallas``); ``DiaBsMatvecLaunch`` is its launch
  prepared once per operator.  K2 and K7 share one device template.

The CUDA sources are ``csrc/lattice_kernels.cu``; ``_build.py`` compiles them
with nvcc on first use.  Each wrapper runs its plain version only for
tensors that lie on the CPU; for a CUDA tensor it launches the kernel or
raises.  Each counts its kernel launches in a plain int attribute
(``<wrapper>.launches``), so a run can show that a path went through the
kernels.

The host side of the assemblers is the JAX package's trace-time reduction,
copied: the constant feature matrix probe (``_probe_constant_M``), the
separable-mask detection (``_detect_factored_masks``) and the scalar-group
reduction that turns every element-tensor entry of a uniform lattice into
``c0 s^3 + c1 s^2 + c2 s`` with s = 1 + jitter.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .._dtypes import numpy_dtype
from .._launch import launch_check, on_device

__all__ = [
    "FoldTable",
    "assemble_fold_lean_blocked",
    "assemble_fold_lean_factored",
    "assemble_fold_lean_factored_plain",
    "assemble_fold_lean_masked",
    "assemble_fold_lean_masked_plain",
    "assemble_fold_lean_raw",
    "assemble_fold_lean_raw_plain",
    "BlockedMatvecLaunch",
    "blocked_launch_params",
    "blocked_launch_table",
    "blocked_matvec",
    "blocked_matvec_plain",
    "build_fold_table",
    "DiaBsMatvecLaunch",
    "DiaMatvecLaunch",
    "K2_MAX_HALO",
    "dia_launch_params",
    "dia_matvec",
    "dia_matvec_bs",
    "dia_matvec_plain",
    "fold_kernel_supported",
    "k2_halo_width",
]

_FLOATS = (torch.float32, torch.float64)


def declare_signatures(lib: ctypes.CDLL) -> None:
    """ctypes argtypes/restype of the launchers in csrc/lattice_kernels.cu."""
    P, I = ctypes.c_void_p, ctypes.c_int
    for suf, F in (("f32", ctypes.c_float), ("f64", ctypes.c_double)):
        mv = getattr(lib, f"dmt_dia_matvec_{suf}")
        mv.argtypes = [P, P, P, P, P]
        mv.restype = I
        fa = getattr(lib, f"dmt_fold_assemble_{suf}")
        fa.argtypes = [P, I, I, I, I, I, I, I, P, P, P, P, I, F, F, P]
        fa.restype = I
        fm = getattr(lib, f"dmt_fold_assemble_masked_{suf}")
        fm.argtypes = [P, I, I, I, I, I, I, I, P, P, P, P, P, F, F, P]
        fm.restype = I
        bm = getattr(lib, f"dmt_blocked_matvec_{suf}")
        bm.argtypes = [P, P, P, P, P, P]
        bm.restype = I
        fr = getattr(lib, f"dmt_fold_assemble_raw_{suf}")
        fr.argtypes = [P, I, I, I, I, I, I, I, P, P, P, I, F, P]
        fr.restype = I


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


# ---------------------------------------------------------------------------
# host reduction (copied from the JAX package's trace-time code)
# ---------------------------------------------------------------------------


def _unit_features(bs, g, dtype=np.float64):
    """Probe Args: one per feature (component k, then value + g gradient
    entries).  Feature index layout: alpha = k*(1+g) + (0 for value, 1+t).
    (dolfinx_mpc_tpu/ops/soa_kernels.py:_unit_features)"""
    from ..fem.forms import Arg

    probes = []
    for k in range(bs):
        val = np.zeros(bs, dtype)
        val[k] = 1.0
        probes.append(Arg(val[0] if bs == 1 else val, np.zeros((bs, g) if bs > 1 else g, dtype)))
        for t in range(g):
            gr = np.zeros((bs, g), dtype)
            gr[k, t] = 1.0
            probes.append(Arg(np.zeros(bs, dtype)[0] if bs == 1 else np.zeros(bs, dtype),
                              gr[0] if bs == 1 else gr))
    return probes


def _probe_constant_M(term, gdim, bs=1):
    """Constant feature matrix of a bilinear integrand: features per
    component k are [value_k, d/dx_k, d/dy_k, d/dz_k]; integrand(u, v, ctx)
    must be bilinear with x-independent coefficients and no FEM
    coefficients.  Returns (bs*(1+gdim), bs*(1+gdim)) numpy M or None."""
    if term.coefficients:
        return None
    from ..fem.forms import Ctx

    nFb = bs * (1 + gdim)
    probes = _unit_features(bs, gdim)
    consts = {k: np.asarray(v) for k, v in term.constants.items()}

    def mat(x):
        out = np.zeros((nFb, nFb))
        ctx = Ctx(np.asarray(x), None, dict(consts))
        for f in range(nFb):
            for g in range(nFb):
                try:
                    v = complex(np.asarray(term.integrand(probes[f], probes[g], ctx)))
                except Exception:  # any integrand the numpy probe cannot evaluate
                    return None
                if v.imag != 0:
                    return None
                out[f, g] = v.real
        return out

    rng = np.random.default_rng(11)
    M1 = mat(rng.random(gdim))
    if M1 is None:
        return None
    M2 = mat(rng.random(gdim))
    if M2 is None or not np.allclose(M1, M2, rtol=1e-12, atol=1e-14):
        return None  # x-dependent coefficients
    return M1


def fold_kernel_supported(clf) -> bool:
    """The lean fold forms the assemblers cover: 3D, scalar at degree 1 or
    2 and block size <= 3 at degree 1, constant feature matrix
    (``pallas_supported`` without its backend and f32 conditions)."""
    if not (clf.refine in (1, 2) and (clf.bs == 1 or (clf.bs <= 3 and clf.refine == 1))
            and clf.mesh.tdim == 3):
        return False
    return _probe_constant_M(clf.term, clf.mesh.gdim, clf.bs) is not None


def _detect_factored_masks(keep, bc_ind, pads=None):
    """Halo-padded per-axis factors (ki, kj, kk, pi, pj, pk), each
    (n_stack, n_axis + 2), when the keep stack separates into per-axis
    factors (keep[c] == ki[c] ⊗ kj[c] ⊗ kk[c] exactly — axis-aligned
    Dirichlet planes) AND the bc indicator equals pad - keep (multiplicity
    1); else None.  `pads` are the per-class real-slot factors (pi, pj, pk)
    of the blocked layout; the grid layout has no padding, so pad == 1."""
    kb = np.asarray(keep, np.float64)
    ind = np.asarray(bc_ind, np.float64)
    ki = kb.max(axis=(2, 3))
    kj = kb.max(axis=(1, 3))
    kk = kb.max(axis=(1, 2))
    if not np.array_equal(kb, ki[:, :, None, None] * kj[:, None, :, None] * kk[:, None, None, :]):
        return None
    if pads is None:
        pi, pj, pk = np.ones_like(ki), np.ones_like(kj), np.ones_like(kk)
    else:
        pi, pj, pk = (np.asarray(p, np.float64) for p in pads)
    if not np.array_equal(ind, pi[:, :, None, None] * pj[:, None, :, None] * pk[:, None, None, :] - kb):
        return None  # multiplicity > 1 or keep zeros beyond bc + pad
    return tuple(np.pad(f, ((0, 0), (1, 1))) for f in (ki, kj, kk, pi, pj, pk))


@dataclass
class FoldTable:
    """Host table of one lean fold form (float64 numpy / int32).

    planes: (n_planes, 8) rows (ri, ci, di, dj, dk, is_diag, e_begin, e_end)
      per output plane — a DIA plane (offset, test component, trial
      component) on the grid layout, a triple (row class, column class,
      coarse offset) on the blocked one, whose ri/ci are class ids;
    ent: (n_entries, 3) window corners (dax, day, daz); coef: (n_entries, 3)
      closed-form coefficients (c0, c1, c2);
    masks: either `factors`, the halo-padded keep/pad factors (ki, kj, kk,
      pi, pj, pk) of a separable mask (K1, K4), or `keep`, the halo-padded
      keep stack (n_stack, n0+2, n1+2, n2+2), with `bc_ind`, the bc-dof
      multiplicity stack (n_stack, n0, n1, n2) (K3), or neither for a form
      without Dirichlet dofs (K5);
    blocked: the planes live on the parity-blocked class grids;
    refine: r of the placement, 2 on the refined degree-2 grid (K5 only),
      where entry e covers the points (dax, day, daz) + r q of the boxes q."""

    vshape: tuple
    dims: tuple
    planes: np.ndarray
    ent: np.ndarray
    coef: np.ndarray
    factors: Optional[tuple]
    keep: Optional[np.ndarray] = None
    bc_ind: Optional[np.ndarray] = None
    blocked: bool = False
    refine: int = 1
    _on: dict = field(default_factory=dict, repr=False)

    @property
    def n_planes(self):
        return self.planes.shape[0]

    def on(self, device, dtype) -> "FoldTableDevice":
        """The table as tensors on `device` in `dtype`, uploaded once."""
        key = (str(torch.device(device)), dtype)
        if key not in self._on:
            self._on[key] = FoldTableDevice(self, torch.device(device), dtype)
        return self._on[key]


class FoldTableDevice:
    """FoldTable tensors on one device: int32 planes/entries, coefficients
    and the masks in the working dtype — the packed factor buffer
    [ki | pi | kj | pj | kk | pk] (factored), the keep and bc stacks
    (masked), or none (raw)."""

    def __init__(self, table: FoldTable, device, dtype):
        self.vshape, self.dims = table.vshape, table.dims
        self.n_planes = table.n_planes
        self.blocked, self.refine = table.blocked, table.refine
        self.dtype = dtype
        self.planes = torch.as_tensor(table.planes, dtype=torch.int32, device=device).contiguous()
        self.ent = torch.as_tensor(table.ent, dtype=torch.int32, device=device).contiguous()
        self.coef = torch.as_tensor(table.coef, dtype=dtype, device=device).contiguous()
        self.factors = self.fac = self.keep = self.bc_ind = None
        self.n_stack = 0
        if table.factors is not None:
            ki, kj, kk, pi, pj, pk = table.factors
            self.n_stack = ki.shape[0]
            self.factors = tuple(torch.as_tensor(f, dtype=dtype, device=device)
                                 for f in (ki, kj, kk, pi, pj, pk))
            self.fac = torch.as_tensor(
                np.concatenate([f.ravel() for f in (ki, pi, kj, pj, kk, pk)]),
                dtype=dtype, device=device).contiguous()
        elif table.keep is not None:
            self.n_stack = table.keep.shape[0]
            self.keep = torch.as_tensor(table.keep, dtype=dtype, device=device).contiguous()
            self.bc_ind = torch.as_tensor(table.bc_ind, dtype=dtype, device=device).contiguous()

    @property
    def device(self):
        return self.coef.device


def build_fold_table(clf, factors=None, keep=None, bc_ind=None, _refined=False) -> FoldTable:
    """The scalar-group reduction of the JAX package's trace-time code
    (dolfinx_mpc_tpu/ops/pallas_lattice.py:288-397) for every output plane
    of a lean fold form, regrouped per plane.  On the blocked layout
    (``clf._blocked``) it runs over the ``_BlockedView`` quantities of
    pallas_lattice.py:693-706: the class grids ``_cdims``, the triples and
    the coarse moves ``_bmoves`` at refine 1, with one mask row per triple
    (pallas_lattice.py:327-336).  `factors` from _detect_factored_masks, or
    the unpadded `keep` and `bc_ind` stacks for the masked form, or neither
    for the raw (unmasked) table of K5.  `_refined` takes a degree-2 form's
    refined vertex-grid layout instead of the blocked one: the 65 refined
    DIA planes at refine r = 2, a raw table that only K5 reads (the JAX
    package's unblocked degree-2 assembly; the port's degree-2 operator is
    the blocked one).

    The lean contract is a UNIFORM lattice whose only runtime input is the
    scalar jitter s = 1 + jit: every vertex coordinate is s * (const), so
    det scales as s^3 and each physical-gradient feature as 1/s.  A move's
    element value is therefore c0 s^3 + c1 s^2 + c2 s (c_k = sum of M-pairs
    with k gradient features, evaluated on the s=1 geometry), summed here
    over every move sharing an output window."""
    from ..fem.quadrature import quadrature_rule

    lat = clf.lat
    nx, ny, nz = lat.dims
    bs = clf.bs
    blocked = bool(clf._blocked) and not _refined
    if _refined and (factors is not None or keep is not None):
        raise ValueError("the refined degree-2 table is raw: K5 reads no masks")
    if blocked:
        cid = {c: i for i, c in enumerate(clf._classes)}
        vshape, moves, r = clf._cdims, clf._bmoves, 1
        # bs == 1: the plane key of a triple is its id
        mask_info = [(cid[cr], cid[cc], off) for cr, cc, off in clf.trips]
    else:
        vshape, moves, r = clf.vshape, clf.moves, clf.refine
        mask_info = [(ci, cj, off) for off in clf.offsets for ci in range(bs) for cj in range(bs)]
    geo = clf._geo_deltas  # (T, 4, 3) vertex deltas
    T = geo.shape[0]
    spacing = tuple(float(v) for v in clf._spacing)
    el = clf.V.element
    qdeg = clf.term.quad_degree
    if qdeg is None:
        qdeg = 2 * el.degree
    qpts, qw = quadrature_rule(clf.mesh.ref_cell, qdeg)
    phi = el.tabulate(qpts)  # (nq, nd) scalar nodes
    dref = el.tabulate_grad(qpts)  # (nq, nd, 3)
    nq = len(qw)
    nF = 1 + clf.mesh.gdim  # per-component features [value, dx, dy, dz]
    M = _probe_constant_M(clf.term, clf.mesh.gdim, bs)
    if M is None:
        raise ValueError("form has no constant feature matrix")
    # nonzero (f, g) feature pairs per (test ci, trial cj) component block
    nzM = {
        (ci, cj): [(f, g) for f in range(nF) for g in range(nF)
                   if abs(M[cj * nF + f, ci * nF + g]) > 0.0]
        for ci in range(bs) for cj in range(bs)
    }
    by_dax = {d: [] for d in range(r + 1)}
    for t, a, b, oid, (dax, day, daz) in moves:
        by_dax[dax].append((t, a, b, oid, day, daz))
    det1 = np.zeros(T)
    gX1 = np.zeros((T, 3, 3))  # [t, i, d]
    for t in range(T):
        J = np.array([[spacing[d] * (geo[t, v + 1, d] - geo[t, 0, d]) for v in range(3)]
                      for d in range(3)])
        det1[t] = np.linalg.det(J)
        gX1[t] = np.linalg.inv(J)  # [i, d]: ref coord i -> phys coord d
    scalar_groups = [dict() for _ in range(r + 1)]
    for dax in range(r + 1):
        for t, a_, b_, oid, day, daz in by_dax[dax]:
            absdet = abs(det1[t])
            for ci in range(bs):
                for cj in range(bs):
                    pairs = nzM[(ci, cj)]
                    if not pairs:
                        continue
                    c = np.zeros(3)
                    for iq in range(nq):
                        ga = {nd_: dref[iq, nd_] @ gX1[t] for nd_ in (a_, b_)}
                        for f, g_ in pairs:
                            fu = phi[iq, b_] if f == 0 else ga[b_][f - 1]
                            fv = phi[iq, a_] if g_ == 0 else ga[a_][g_ - 1]
                            k = (f > 0) + (g_ > 0)
                            c[k] += float(qw[iq]) * absdet * M[cj * nF + f, ci * nF + g_] * fu * fv
                    keyg = ((oid * bs + ci) * bs + cj, day, daz)
                    acc = scalar_groups[dax].setdefault(keyg, np.zeros(3))
                    acc += c
    per_plane = {}
    for dax in range(r + 1):
        for (foid, day, daz), c in scalar_groups[dax].items():
            if np.any(c != 0.0):  # an all-zero group adds nothing (skipped on the TPU too)
                per_plane.setdefault(foid, []).append((dax, day, daz, c))
    planes = np.zeros((len(mask_info), 8), np.int32)
    ent, coef = [], []
    for mi, (ri, ci, (di, dj, dk)) in enumerate(mask_info):
        e0 = len(ent)
        for dax, day, daz, c in per_plane.get(mi, ()):
            ent.append((dax, day, daz))
            coef.append(c)
        planes[mi] = (ri, ci, di, dj, dk, int(ri == ci and (di, dj, dk) == (0, 0, 0)), e0, len(ent))
    if factors is None and keep is not None:
        if max(abs(v) for _, _, off in mask_info for v in off) > 1:
            raise ValueError("the masked assembler reads a one-point halo: offsets beyond ±1")
        keep = np.pad(np.asarray(keep, np.float64), ((0, 0), (1, 1), (1, 1), (1, 1)))
        bc_ind = np.asarray(bc_ind, np.float64)
    else:
        keep = bc_ind = None
    return FoldTable(tuple(vshape), (nx, ny, nz), planes,
                     np.asarray(ent, np.int32).reshape(-1, 3),
                     np.asarray(coef, np.float64).reshape(-1, 3), factors,
                     keep, bc_ind, blocked, r)


# ---------------------------------------------------------------------------
# K1 / K4 / K3: fused lean-fold assemblers
# ---------------------------------------------------------------------------


def _window_sums(tab: FoldTableDevice, jitter):
    """Unmasked planes (n_planes, n0, n1, n2): every table entry's value
    c0 s^3 + c1 s^2 + c2 s, computed in tab's dtype as the kernels do,
    added over its box window (with stride r on the refined grid).
    Returns (planes, table rows)."""
    n0, n1, n2 = tab.vshape
    nx, ny, nz = tab.dims
    r = tab.refine
    np_dt = numpy_dtype(tab.dtype)
    s = np_dt.type(1.0 + jitter)
    s2 = s * s
    s3 = s2 * s
    coef = tab.coef.cpu().numpy()
    ent = tab.ent.tolist()
    rows = tab.planes.tolist()
    out = torch.zeros((tab.n_planes, n0, n1, n2), dtype=tab.dtype, device=tab.device)
    for mi, (*_, e0, e1) in enumerate(rows):
        for e in range(e0, e1):
            dax, day, daz = ent[e]
            c0, c1, c2 = coef[e]
            out[mi, dax:dax + r * nx:r, day:day + r * ny:r, daz:daz + r * nz:r] += float(
                c0 * s3 + c1 * s2 + c2 * s)
    return out, rows


def assemble_fold_lean_raw_plain(tab: FoldTableDevice, jitter):
    """Plain PyTorch version of K5 on tab's device: the window slice-adds of
    every plane, no masks and no diagonal term.  Output (n_planes, n0, n1,
    n2) in tab's dtype."""
    return _window_sums(tab, jitter)[0]


def assemble_fold_lean_factored_plain(tab: FoldTableDevice, jitter, diagval):
    """Plain PyTorch version of K1 and K4 on tab's device: the same table
    applied as window slice-adds, then the separable row/column masks and
    the diagonal bc term dv * (pad - keep).  Output (n_planes, n0, n1, n2)
    in tab's dtype."""
    n0, n1, n2 = tab.vshape
    ki, kj, kk, pi, pj, pk = tab.factors
    dv = float(numpy_dtype(tab.dtype).type(diagval))
    out, rows = _window_sums(tab, jitter)

    def outer3(fi, fj, fk, c, di=0, dj=0, dk=0):  # separable mask on the (shifted) grid
        return (fi[c, 1 + di:1 + di + n0][:, None, None] * fj[c, 1 + dj:1 + dj + n1][None, :, None]
                * fk[c, 1 + dk:1 + dk + n2][None, None, :])

    for mi, (ri, ci, di, dj, dk, is_diag, e0, e1) in enumerate(rows):
        if e0 == e1:
            continue
        o = out[mi]
        row = outer3(ki, kj, kk, ri)
        o.mul_(row * outer3(ki, kj, kk, ci, di, dj, dk))
        if is_diag:
            o.add_(dv * (outer3(pi, pj, pk, ri) - row))
    return out


def assemble_fold_lean_masked_plain(tab: FoldTableDevice, jitter, diagval):
    """Plain PyTorch version of K3 on tab's device: the window slice-adds,
    then the row mask keep[ri] at (p, j, k), the column mask keep[ci] at
    (p+di, j+dj, k+dk) from the halo-padded stack, and dv * bc_ind[ri] on
    the diagonal planes (pallas_lattice.py:564-573)."""
    n0, n1, n2 = tab.vshape
    kp, ind = tab.keep, tab.bc_ind
    dv = float(numpy_dtype(tab.dtype).type(diagval))
    out, rows = _window_sums(tab, jitter)
    for mi, (ri, ci, di, dj, dk, is_diag, e0, e1) in enumerate(rows):
        if e0 == e1:
            continue
        o = out[mi]
        row = kp[ri, 1:1 + n0, 1:1 + n1, 1:1 + n2]
        o.mul_(row * kp[ci, 1 + di:1 + di + n0, 1 + dj:1 + dj + n1, 1 + dk:1 + dk + n2])
        if is_diag:
            o.add_(dv * ind[ri])
    return out


def _check_table(tab, name, masks, blocked=None):
    """Device, dtype and layout checks of an assembler launch; `masks` is
    the table kind the kernel reads: "factored", "masked" or "raw" (any
    table, masks ignored)."""
    dev = tab.device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {dev}")
    if tab.dtype not in _FLOATS:
        raise TypeError(f"{name}: dtype {tab.dtype} is not float32/float64")
    if masks == "factored" and tab.factors is None:
        raise ValueError(f"{name}: the table holds no separable mask factors")
    if masks == "masked" and tab.keep is None:
        raise ValueError(f"{name}: the table holds no keep stack")
    if masks != "raw" and tab.refine != 1:
        raise ValueError(f"{name}: the refined degree-2 table is K5's alone")
    if blocked is not None and tab.blocked != blocked:
        raise ValueError(f"{name}: the table is {'' if tab.blocked else 'not '}on the blocked layout")


def _fold_factored(wrapper, blocked, tab: FoldTableDevice, jitter, diagval):
    """The body of K1's and K4's wrappers: the plain version on a CPU table,
    else one launch of fold_assemble_kernel, counted on `wrapper`."""
    if tab.device.type == "cpu":
        return assemble_fold_lean_factored_plain(tab, jitter, diagval)
    name = wrapper.__name__
    _check_table(tab, name, "factored", blocked=blocked)
    from .._build import load_kernels

    lib = load_kernels()
    dev = tab.device
    n0, n1, n2 = tab.vshape
    nx, ny, nz = tab.dims
    out = torch.empty((tab.n_planes, n0, n1, n2), dtype=tab.dtype, device=dev)
    F = ctypes.c_float if tab.dtype == torch.float32 else ctypes.c_double
    with torch.cuda.device(dev):
        rc = getattr(lib, f"dmt_fold_assemble_{_suffix(tab.dtype)}")(
            out.data_ptr(), tab.n_planes, n0, n1, n2, nx, ny, nz,
            tab.planes.data_ptr(), tab.ent.data_ptr(), tab.coef.data_ptr(), tab.fac.data_ptr(),
            tab.n_stack, F(1.0 + float(jitter)), F(float(diagval)),
            torch.cuda.current_stream(dev).cuda_stream)
    launch_check(rc, name)
    wrapper.launches += 1
    return out


def assemble_fold_lean_factored(tab: FoldTableDevice, jitter, diagval):
    """K1: BC-masked constrained stiffness of a degree-1 lean fold form as
    DIA planes (n_planes, n0, n1, n2), plane order (offset, ci, cj).

    Replaces the TPU kernel dolfinx_mpc_tpu/ops/pallas_lattice.py:
    _make_lean_fold_pallas_group -> kernel_factored.  On the card it is
    bound by its single write of the output (16.5 MB per fine-level assembly
    at n=64 in f32): one thread per output value, k fastest for coalesced
    stores, the ~10^2-entry table and the factor rows read through the
    read-only cache.  CPU tables run the plain version."""
    return _fold_factored(assemble_fold_lean_factored, False, tab, jitter, diagval)


assemble_fold_lean_factored.launches = 0


def assemble_fold_lean_blocked(tab: FoldTableDevice, jitter, diagval):
    """K4: the degree-2 lean fold operator on the parity-blocked layout,
    (n_triples, s0, s1, s2) over the padded class grids, triple order of
    ``CompiledLatticeForm.trips``.

    Replaces the TPU kernel dolfinx_mpc_tpu/ops/pallas_lattice.py:
    make_lean_blocked_pallas, which is K1's Pallas code over _BlockedView;
    here too it launches K1's device code, on the blocked table (8 classes,
    230 triples for P2 tets, per-class pad factors so that every padded
    slot comes out an exact 0).  Bound by the write: 230 x 65^3 values,
    253 MB at n=64 in f32.  CPU tables run the plain version."""
    return _fold_factored(assemble_fold_lean_blocked, True, tab, jitter, diagval)


assemble_fold_lean_blocked.launches = 0


def assemble_fold_lean_masked(tab: FoldTableDevice, jitter, diagval):
    """K3: the lean fold operator with non-separable bc masks, on either
    layout (DIA planes on the vertex grid, triples on the class grids).

    Replaces the TPU kernel dolfinx_mpc_tpu/ops/pallas_lattice.py:
    kernel_masked (fuse mode "2d").  K1's thread layout; the masks are two
    reads of the halo-padded keep stack (row and shifted column) and, on
    the diagonal planes, one of the bc multiplicity stack, all from device
    memory.  Bound by the write plus those reads; there is no VMEM budget,
    so the JAX package's "2d" size limit is not carried.  CPU tables run
    the plain version."""
    if tab.device.type == "cpu":
        return assemble_fold_lean_masked_plain(tab, jitter, diagval)
    _check_table(tab, "assemble_fold_lean_masked", "masked")
    from .._build import load_kernels

    lib = load_kernels()
    dev = tab.device
    n0, n1, n2 = tab.vshape
    nx, ny, nz = tab.dims
    out = torch.empty((tab.n_planes, n0, n1, n2), dtype=tab.dtype, device=dev)
    F = ctypes.c_float if tab.dtype == torch.float32 else ctypes.c_double
    with torch.cuda.device(dev):
        rc = getattr(lib, f"dmt_fold_assemble_masked_{_suffix(tab.dtype)}")(
            out.data_ptr(), tab.n_planes, n0, n1, n2, nx, ny, nz,
            tab.planes.data_ptr(), tab.ent.data_ptr(), tab.coef.data_ptr(),
            tab.keep.data_ptr(), tab.bc_ind.data_ptr(), F(1.0 + float(jitter)), F(float(diagval)),
            torch.cuda.current_stream(dev).cuda_stream)
    launch_check(rc, "assemble_fold_lean_masked")
    assemble_fold_lean_masked.launches += 1
    return out


assemble_fold_lean_masked.launches = 0


def assemble_fold_lean_raw(tab: FoldTableDevice, jitter):
    """K5: the unmasked planes of a lean fold form, (n_planes, n0, n1, n2)
    in the table's plane order: DIA planes (offset, ci, cj) on the vertex
    grid (any bs), triples on the blocked class grids, or the refined
    degree-2 DIA planes (``build_fold_table(..., _refined=True)``).  The
    operator of a form without Dirichlet dofs, whose masks are identities.

    Replaces the TPU kernel dolfinx_mpc_tpu/ops/pallas_lattice.py:
    _make_lean_fold_pallas_group -> kernel (fuse mode None).  K1's thread
    layout without the mask reads and the diagonal term: bound by the one
    write (135 x 65^3 values, 148 MB, for P1 elasticity at n=64 in f32;
    65 x 129^3, 558 MB, on the refined P2 n=64 grid).  On the refined grid
    an entry adds only at the points of its corner's parity, the stride-r
    form of the TPU kernel's pltpu.repeat upsampling times its parity
    mask.  Any mask stack the table holds is not read.  CPU tables run the
    plain version."""
    if tab.device.type == "cpu":
        return assemble_fold_lean_raw_plain(tab, jitter)
    _check_table(tab, "assemble_fold_lean_raw", "raw")
    from .._build import load_kernels

    lib = load_kernels()
    dev = tab.device
    n0, n1, n2 = tab.vshape
    nx, ny, nz = tab.dims
    out = torch.empty((tab.n_planes, n0, n1, n2), dtype=tab.dtype, device=dev)
    F = ctypes.c_float if tab.dtype == torch.float32 else ctypes.c_double
    with torch.cuda.device(dev):
        rc = getattr(lib, f"dmt_fold_assemble_raw_{_suffix(tab.dtype)}")(
            out.data_ptr(), tab.n_planes, n0, n1, n2, nx, ny, nz,
            tab.planes.data_ptr(), tab.ent.data_ptr(), tab.coef.data_ptr(), tab.refine,
            F(1.0 + float(jitter)), torch.cuda.current_stream(dev).cuda_stream)
    launch_check(rc, "assemble_fold_lean_raw")
    assemble_fold_lean_raw.launches += 1
    return out


assemble_fold_lean_raw.launches = 0


# ---------------------------------------------------------------------------
# K2: DIA SpMV
# ---------------------------------------------------------------------------


def dia_matvec_plain(data, offsets, vshape, bs, x):
    """Plain PyTorch DIA matvec (the slice-FMA of dolfinx_mpc_tpu/ops/
    lattice.py:142-164): data (n_off, bs, bs, n0, n1, n2), x interleaved
    (n0*n1*n2*bs,).  Any device, any bs."""
    n0, n1, n2 = vshape
    xg = torch.movedim(x.reshape(n0, n1, n2, bs), -1, 0)
    y = torch.zeros_like(xg)
    for d, (di, dj, dk) in enumerate(offsets):
        dst = (slice(max(-di, 0), n0 - max(di, 0)),
               slice(max(-dj, 0), n1 - max(dj, 0)),
               slice(max(-dk, 0), n2 - max(dk, 0)))
        src = (slice(max(di, 0), n0 + min(di, 0)),
               slice(max(dj, 0), n1 + min(dj, 0)),
               slice(max(dk, 0), n2 + min(dk, 0)))
        for ci in range(bs):
            acc = None
            for cj in range(bs):
                term = data[(d, ci, cj) + dst] * xg[(cj,) + src]
                acc = term if acc is None else acc + term
            y[(ci,) + dst] += acc
    return torch.movedim(y, 0, -1).reshape(-1)


# K2's and K7's halo: the widest offset the kernel's shared-memory ring
# takes, and the most offsets its parameter block holds
# (csrc/lattice_kernels.cu)
K2_MAX_HALO = 2
K2_MAX_OFFSETS = 128
_K2_POINTS = 256  # plane points per block (kDiaPoints)
_SMEM_MAX = 232448  # shared memory one block may use on the H100
_SMS = 132
_L2_BYTES = 50 * 2 ** 20  # operators beyond the L2 stream their data planes evict-first


class DiaParams(ctypes.Structure):
    """The parameter block of K2 (bs = 1) and K7 (bs = 2, 3) (struct
    DiaParams of csrc/lattice_kernels.cu), built once per operator: the
    offsets as plane offset di, flat shift dj*n2 + dk inside the plane and
    dk, the halo width, the components per point, the grid, the x planes
    per block and K7's evict-first data loads."""

    _fields_ = [("n", ctypes.c_int), ("w", ctypes.c_int), ("bs", ctypes.c_int), ("n0", ctypes.c_int),
                ("n1", ctypes.c_int), ("n2", ctypes.c_int), ("li", ctypes.c_int),
                ("di", ctypes.c_int * K2_MAX_OFFSETS), ("sh", ctypes.c_int * K2_MAX_OFFSETS),
                ("dk", ctypes.c_int * K2_MAX_OFFSETS), ("stream", ctypes.c_int)]


def k2_halo_width(offsets) -> int:
    """The halo width K2 and K7 launch with for these offsets: max |d| over
    all axes, at least 1; raises beyond K2_MAX_HALO."""
    w = max([abs(int(v)) for o in offsets for v in o], default=0)
    if w > K2_MAX_HALO:
        raise ValueError(f"dia_matvec: an offset reaches {w} planes, beyond K2's halo width {K2_MAX_HALO}")
    return max(w, 1)


def dia_launch_params(offsets, vshape, itemsize=4, bs=1) -> DiaParams:
    """The parameter block of K2 (bs = 1) or K7 (bs = 2, 3) for `offsets`
    on the (n0, n1, n2) grid.  Each block takes 256 consecutive points of
    the flattened (j, k) plane; the x planes per block (li) are the most of
    8, 4, 2 that still give 16 blocks per SM (two full waves at 8 resident
    blocks), else 1: on the H100 the device time fell with more blocks down
    to that point (K2 65^3: 0.0096 ms at li 4, 0.0082 at 2; 129^3: 0.0748 at
    16, 0.0581 at 4; chip_smoke.py's sweep), and K7, with 9x the work per
    point, gives 1 on every grid of the bs=3 path (65^3 and below).  K7
    loads the data planes evict-first where they exceed the 50 MB L2 (65^3
    x 3: 148 MB), where that was faster on the H100, and through the cache
    where they fit (33^3 x 3: 19 MB stays L2-resident between calls).  Raises
    where the kernel cannot take the operator: too many offsets, an offset
    beyond the halo, a grid of 2^31 values or more, or a shared-memory ring
    beyond one block's 227 KB."""
    n0, n1, n2 = (int(v) for v in vshape)
    name = "dia_matvec" if bs == 1 else "dia_matvec_bs"
    if bs not in (1, 2, 3):
        raise ValueError(f"{name}: bs={bs} (the kernel is built for 1, 2 and 3)")
    offsets = [tuple(int(v) for v in o) for o in offsets]
    if len(offsets) > K2_MAX_OFFSETS:
        raise ValueError(f"{name}: {len(offsets)} offsets, the kernel takes at most {K2_MAX_OFFSETS}")
    w = k2_halo_width(offsets)
    if n0 * n1 * n2 * bs >= 2 ** 31:
        raise ValueError(f"{name}: grid {vshape} at bs={bs} has 2^31 values or more")
    if (2 * w + 2) * (_K2_POINTS + 2 * (w * n2 + w)) * bs * itemsize > _SMEM_MAX:
        raise ValueError(f"{name}: rows of {n2} points need more shared memory than a block has")
    tiles = -(-(n1 * n2) // _K2_POINTS)
    li = next((li for li in (8, 4, 2) if tiles * -(-n0 // li) >= 16 * _SMS), 1)
    stream = int(bs > 1 and len(offsets) * bs * bs * n0 * n1 * n2 * itemsize > _L2_BYTES)
    p = DiaParams(n=len(offsets), w=w, bs=bs, n0=n0, n1=n1, n2=n2, li=li, stream=stream)
    for d, (di, dj, dk) in enumerate(offsets):
        p.di[d], p.sh[d], p.dk[d] = di, dj * n2 + dk, dk
    return p


class _DiaLaunch:
    """A DIA SpMV launch prepared once per operator: the parameter block,
    the ctypes function of the dtype, data's pointer and the device checks.
    A call allocates y, reads the current stream and makes one ctypes
    call."""

    def __init__(self, data, offsets, vshape, bs, name):
        n0, n1, n2 = (int(v) for v in vshape)
        n_off = len(offsets)
        self.name = name
        if data.device.type != "cuda":
            raise RuntimeError(f"{name}: data on {data.device}")
        if data.dtype not in _FLOATS:
            raise TypeError(f"{name}: data {data.dtype} (need float32/float64)")
        self.n = n0 * n1 * n2 * bs
        if data.numel() != n_off * bs * self.n:
            raise ValueError(f"{name}: data {tuple(data.shape)} does not match {n_off} offsets on {vshape} "
                             f"at bs={bs}")
        if not data.is_contiguous():
            raise ValueError(f"{name}: data must be contiguous")
        from .._build import load_kernels

        self.params = dia_launch_params(offsets, vshape, data.element_size(), bs)
        self.vshape = (n0, n1, n2)
        self.data = data  # keeps the pointer valid
        self.device, self.dtype = data.device, data.dtype
        self.index = data.device.index if data.device.index is not None else torch.cuda.current_device()
        self.fn = getattr(load_kernels(), f"dmt_dia_matvec_{_suffix(data.dtype)}")
        self.args = (data.data_ptr(), ctypes.addressof(self.params))

    def _launch(self, x):
        if x.device != self.device:
            raise RuntimeError(f"{self.name}: data on {self.device}, x on {x.device}")
        if x.dtype != self.dtype:
            raise TypeError(f"{self.name}: data {self.dtype}, x {x.dtype}")
        if x.numel() != self.n or not x.is_contiguous():
            raise ValueError(f"{self.name}: x {tuple(x.shape)}, need {self.n} contiguous values")
        y = torch.empty(self.n, dtype=self.dtype, device=self.device)
        dp, pp = self.args
        xp, yp = x.data_ptr(), y.data_ptr()
        launch_check(on_device(self.index, lambda st: self.fn(dp, xp, yp, pp, st)), self.name)
        return y


class DiaMatvecLaunch(_DiaLaunch):
    """K2 prepared once per operator (a bs = 1 DIAMatrix on the card)."""

    def __init__(self, data, offsets, vshape):
        super().__init__(data, offsets, vshape, 1, "dia_matvec")

    def __call__(self, x):
        y = self._launch(x)
        dia_matvec.launches += 1
        return y


class DiaBsMatvecLaunch(_DiaLaunch):
    """K7 prepared once per operator (a bs = 2 or 3 DIAMatrix on the card).
    Besides its count, each launch adds one to
    dia_matvec_bs.launches_by_grid[vshape]."""

    def __init__(self, data, offsets, vshape, bs):
        if bs not in (2, 3):
            raise ValueError(f"dia_matvec_bs: bs={bs} (the kernel is built for 2 and 3)")
        super().__init__(data, offsets, vshape, bs, "dia_matvec_bs")

    def __call__(self, x):
        y = self._launch(x)
        dia_matvec_bs.launches += 1
        by_grid = dia_matvec_bs.launches_by_grid
        by_grid[self.vshape] = by_grid.get(self.vshape, 0) + 1
        return y


def dia_matvec(data, offsets, vshape, x):
    """K2: scalar DIA SpMV y[p] = sum_d data[d, p] x[p + off_d] (zero outside
    the grid); data (n_off, 1, 1, n0, n1, n2) or (n_off, n0, n1, n2), x flat.

    Replaces the TPU kernel dolfinx_mpc_tpu/ops/pallas_lattice.py:
    _make_dia_matvec_group.  On the card it is bound by device memory,
    (n_off + 2) values per point: 2.5-D blocking, each block marching along
    i over a range of the flattened (j, k) plane with a cp.async ring of the
    2W+1 x planes (W = max |d| <= 2) in shared memory, zero-filled outside
    the grid (csrc/lattice_kernels.cu, dia_matvec_kernel at BS = 1).  This
    function prepares the launch for the one call; DIAMatrix prepares it
    once (DiaMatvecLaunch) and calls it directly.  CPU tensors run the plain
    version; every bs=1 DIA matvec on a CUDA tensor launches the kernel, at
    any grid size."""
    n0, n1, n2 = vshape
    n_off = len(offsets)
    if data.device.type == "cpu" and x.device.type == "cpu":
        return dia_matvec_plain(data.reshape(n_off, 1, 1, n0, n1, n2), offsets, vshape, 1, x)
    if data.device.type != "cuda" or x.device != data.device:
        raise RuntimeError(f"dia_matvec: data on {data.device}, x on {x.device}")
    return DiaMatvecLaunch(data, offsets, vshape)(x)


dia_matvec.launches = 0


# ---------------------------------------------------------------------------
# K7: vector (bs > 1) DIA SpMV
# ---------------------------------------------------------------------------


def dia_matvec_bs(data, offsets, vshape, bs, x):
    """K7: vector DIA SpMV y[(v, ci)] = sum_{d, cj} data[d, ci, cj, v]
    x[(v + off_d, cj)] (zero outside the grid); data (n_off, bs, bs, n0,
    n1, n2), x and y interleaved (n0*n1*n2*bs,), bs 2 or 3.

    Replaces the TPU kernel dolfinx_mpc_tpu/ops/pallas_lattice.py:
    make_dia_matvec_bs_pallas, which the JAX package keeps out of dispatch
    for a Mosaic miscompile in composed programs; that defect has no CUDA
    counterpart, so here every bs > 1 DIA matvec on the card runs it, at
    any grid size.  K2's plane-staged design at bs components per point
    (csrc/lattice_kernels.cu, dia_matvec_kernel at BS = 2, 3): the ring
    holds each x plane's flat range with the components interleaved as x
    is, the bs^2 data planes of four offsets at a time are loaded before
    any add, and the bs sums stay in registers in the plain version's order
    (offset, then cj).  Bound by device memory: (bs^2 n_off + 2 bs) values
    per point, 155 MB per fine matvec of P1 elasticity at n=64 in f32.  This
    function prepares the launch for the one call; DIAMatrix prepares it
    once (DiaBsMatvecLaunch).  CPU tensors run the plain version."""
    if data.device.type == "cpu" and x.device.type == "cpu":
        return dia_matvec_plain(data, offsets, vshape, bs, x)
    if data.device.type != "cuda" or x.device != data.device:
        raise RuntimeError(f"dia_matvec_bs: data on {data.device}, x on {x.device}")
    return DiaBsMatvecLaunch(data, offsets, vshape, bs)(x)


dia_matvec_bs.launches = 0
dia_matvec_bs.launches_by_grid = {}


# ---------------------------------------------------------------------------
# K6: parity-blocked SpMV
# ---------------------------------------------------------------------------

_K6_THREADS = 256  # kBlockedThreads
_K6_R = 2  # kBlockedR: points per thread


class BlockedParams(ctypes.Structure):
    """K6's parameter block (struct BlockedParams of
    csrc/lattice_kernels.cu): classes, triples, the class grid, the x
    planes and plane points per block, the classes without triples and the
    evict-first data loads."""

    _fields_ = [("n_cls", ctypes.c_int), ("n_trip", ctypes.c_int), ("s0", ctypes.c_int),
                ("s1", ctypes.c_int), ("s2", ctypes.c_int), ("li", ctypes.c_int), ("pts", ctypes.c_int),
                ("empty", ctypes.c_uint), ("stream", ctypes.c_int)]


def blocked_launch_table(trips, classes, cdims) -> np.ndarray:
    """K6's device table, (n_trip, 2) int32, one row per triple: (column
    class << 24 | s2 + 1 + flat shift dj*s2 + dk, m | row class << 16 |
    last of its class << 21 | (di + 1) << 22 | (dk + 1) << 24).  Rows are
    grouped by row class, each class's triples in triple order: the order
    the plain version sums them.  The kernel turns the first word into the
    triple's offset inside a ring slot of its launch shape.  Raises for a
    coarse offset beyond ±1 (the kernel's halo)."""
    s2 = int(cdims[2])
    cid = {c: i for i, c in enumerate(classes)}
    rows = [[] for _ in classes]
    for m, (cr, cc, (di, dj, dk)) in enumerate(trips):
        if max(abs(di), abs(dj), abs(dk)) > 1:
            raise ValueError("blocked SpMV: coarse offsets beyond ±1")
        rows[cid[cr]].append(((cid[cc] << 24) | (s2 + 1 + dj * s2 + dk),
                              m | (di + 1) << 22 | (dk + 1) << 24))
    out = [(x, y | ci << 16 | int(k == len(r) - 1) << 21)
           for ci, r in enumerate(rows) for k, (x, y) in enumerate(r)]
    return np.asarray(out, np.int64).reshape(-1, 2).astype(np.int32)


def blocked_launch_params(trips, classes, cdims, itemsize=4, pts=None, li=None) -> BlockedParams:
    """K6's parameter block for `trips` over `classes` on the (s0, s1, s2)
    class grids.  By default 256 threads of 2 points each (pts = 512 plane
    points per block) and the fewest x planes per block (li) that make every
    block resident in one wave (two such blocks per SM, fewer where the
    ring's shared memory allows fewer): on the H100 that beat 256 points per
    block and one plane per block at 8 x 65^3 and equals them at 8 x 33^3
    (chip_smoke.py's sweep).  The data planes are loaded evict-first where
    they exceed the 50 MB L2 (8 x 65^3: 253 MB), through the cache where
    they fit (8 x 33^3: 33 MB).  The keywords override the defaults.
    Raises where the kernel cannot take the operator: more than 32 classes
    or 65,535 triples, a class stack of 2^31 values or more, or a ring and
    table beyond one block's 227 KB."""
    s0, s1, s2 = (int(v) for v in cdims)
    n_cls, n_trip = len(classes), len(trips)
    if not 1 <= n_cls <= 32 or not 1 <= n_trip < 2 ** 16:
        raise ValueError(f"blocked_matvec: {n_cls} classes, {n_trip} triples (the kernel takes 1 to 32 "
                         f"classes and 1 to 65535 triples)")
    if max(n_cls, n_trip) * s0 * s1 * s2 >= 2 ** 31:
        raise ValueError(f"blocked_matvec: class grids {cdims} hold 2^31 values or more")
    pts = pts or _K6_R * _K6_THREADS
    smem = 8 * (n_trip + 1) + 4 * n_cls * (pts + 2 * (s2 + 1)) * itemsize
    if smem > _SMEM_MAX:
        raise ValueError(f"blocked_matvec: rows of {s2} points need more shared memory than a block has")
    if li is None:
        resident = _SMS * min(2, _SMEM_MAX // smem)
        li = min(-(-(-(-(s1 * s2) // pts) * s0) // resident), s0)
    rows = {cr for cr, _, _ in trips}
    empty = sum(1 << ci for ci, c in enumerate(classes) if c not in rows)
    stream = int(n_trip * s0 * s1 * s2 * itemsize > _L2_BYTES)
    return BlockedParams(n_cls=n_cls, n_trip=n_trip, s0=s0, s1=s1, s2=s2, li=li, pts=pts, empty=empty,
                         stream=stream)


def blocked_matvec_plain(data, trips, classes, xb):
    """Plain PyTorch blocked SpMV, the halo-pad fused slice-FMA of
    dolfinx_mpc_tpu/ops/lattice.py:330-351: y_b[ci] = sum over the triples
    (cr, cc, off) of row class ci of data[m] * x_b[cc] shifted by off, zero
    outside [0, s).  data (n_trip, s0, s1, s2), xb (n_cls, s0, s1, s2)."""
    cid = {c: i for i, c in enumerate(classes)}
    s0, s1, s2 = xb.shape[1:]
    xh = torch.nn.functional.pad(xb, (1, 1, 1, 1, 1, 1))
    acc = [None] * xb.shape[0]
    for m, (cr, cc, (di, dj, dk)) in enumerate(trips):
        t = data[m] * xh[cid[cc], 1 + di:1 + di + s0, 1 + dj:1 + dj + s1, 1 + dk:1 + dk + s2]
        i = cid[cr]
        acc[i] = t if acc[i] is None else acc[i] + t
    zero = torch.zeros((s0, s1, s2), dtype=xb.dtype, device=xb.device)
    return torch.stack([a if a is not None else zero for a in acc])


class BlockedMatvecLaunch:
    """K6 prepared once per operator (a BlockDIAMatrix on the card): the
    packed triple table on the device, the parameter block, the ctypes
    function of the dtype, the pointers and the device checks.  A call
    allocates y, reads the current stream and makes one ctypes call."""

    def __init__(self, data, trips, classes):
        if data.device.type != "cuda":
            raise RuntimeError(f"blocked_matvec: data on {data.device}")
        if data.dtype not in _FLOATS:
            raise TypeError(f"blocked_matvec: data {data.dtype} (need float32/float64)")
        if data.dim() != 4 or data.shape[0] != len(trips):
            raise ValueError(f"blocked_matvec: data {tuple(data.shape)} does not hold {len(trips)} triples")
        if not data.is_contiguous():
            raise ValueError("blocked_matvec: data must be contiguous")
        from .._build import load_kernels

        cdims = tuple(int(v) for v in data.shape[1:])
        self.shape = (len(classes),) + cdims
        self.params = blocked_launch_params(trips, classes, cdims, data.element_size())
        self.table = torch.as_tensor(blocked_launch_table(trips, classes, cdims), device=data.device)
        self.data = data  # keeps the pointers valid
        self.device, self.dtype = data.device, data.dtype
        self.index = data.device.index if data.device.index is not None else torch.cuda.current_device()
        self.fn = getattr(load_kernels(), f"dmt_blocked_matvec_{_suffix(data.dtype)}")
        self.args = (data.data_ptr(), self.table.data_ptr(), ctypes.addressof(self.params))

    def __call__(self, xb):
        if xb.device != self.device:
            raise RuntimeError(f"blocked_matvec: data on {self.device}, x on {xb.device}")
        if xb.dtype != self.dtype:
            raise TypeError(f"blocked_matvec: data {self.dtype}, x {xb.dtype}")
        if tuple(xb.shape) != self.shape or not xb.is_contiguous():
            raise ValueError(f"blocked_matvec: x {tuple(xb.shape)}, need a contiguous {self.shape}")
        y = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        dp, tp, pp = self.args
        xp, yp = xb.data_ptr(), y.data_ptr()
        launch_check(on_device(self.index, lambda st: self.fn(dp, xp, yp, tp, pp, st)), "blocked_matvec")
        blocked_matvec.launches += 1
        return y


def blocked_matvec(data, trips, classes, xb):
    """K6: blocked SpMV on the padded class stack (n_cls, s0, s1, s2).

    Replaces the TPU kernel dolfinx_mpc_tpu/ops/pallas_lattice.py:
    make_blocked_matvec_pallas.  K2's plane-staged design at W = 1 over all
    classes at once (csrc/lattice_kernels.cu, blocked_matvec_kernel): each
    thread computes every class's output at its points, walking the triple
    table (blocked_launch_table, on the device and staged into shared
    memory) with 32 data loads in flight (16 triples x 2 points), its x
    neighbours read from a cp.async ring of every class's x planes,
    zero-filled outside the grid in place of the halo pad / roll + mask.  Bound by device memory: (n_trip + 2 n_cls) values
    per coarse point, 270 MB per matvec at n=64 in f32.  This function
    prepares the launch for the one call; BlockDIAMatrix prepares it once
    (BlockedMatvecLaunch).  CPU tensors run the plain version."""
    if data.device.type == "cpu" and xb.device.type == "cpu":
        return blocked_matvec_plain(data, trips, classes, xb)
    if data.device.type != "cuda" or xb.device != data.device:
        raise RuntimeError(f"blocked_matvec: data on {data.device}, x on {xb.device}")
    return BlockedMatvecLaunch(data, trips, classes)(xb)


blocked_matvec.launches = 0
