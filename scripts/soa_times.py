#!/usr/bin/env python3
"""Device time of the cells-last SoA element kernel (ops/soa_kernels.py)
against the cell-first kernel, at chip_smoke.py 13e's size, on one card.

    python3 scripts/soa_times.py [--root DIR]

Forms, each on every cell of the P1 n=64 unit cube (1,572,864 cells):
13e's coefficient form kappa (grad u, grad v), kappa = 1 + x0 x1 (M per
cell, 3 nonzero entries), in float64 and float32; and P1 vector elasticity
2 (sym grad u, sym grad v) + 1.25 div u div v (constant M, bs = 3, many
nonzero entries) in float64.  Each line gives the SoA kernel's and the
cell-first kernel's CUDA-event time in ms (chip_smoke.cuda_ms) and
max|Ae_soa - Ae_cell_first| / max|Ae| (gate 1e-12 in float64, 5e-6 in
float32).  DIR, a `git archive` of another commit under the git-ignored
build/archive/, times that commit's package alike: run this script, not
DIR's copy, for both, alternating the two in one call.  Run from the
repository root."""

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main():
    root = Path(sys.argv[sys.argv.index("--root") + 1]).resolve() if "--root" in sys.argv else HERE
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import numpy as np
    import torch

    import dolfinx_mpc_tpu_torch as dmt
    from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube
    from dolfinx_mpc_tpu_torch.ops.assemble import _coeff_vectors

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    if Path(dmt.__file__).resolve().parents[1] != root:
        cs.fail(f"dolfinx_mpc_tpu_torch came from {dmt.__file__}, not from {root}")
    dev, n = torch.device("cuda"), cs.N_FORMATS
    print(cs.card_line(), f"root {root}", flush=True)
    mesh = create_unit_cube(n, n, n)

    def times(form, vector, dtype, side):
        V = dmt.functionspace(mesh, ("Lagrange", 1, (3,)) if vector else ("Lagrange", 1))
        bc = dmt.dirichletbc(np.zeros(3) if vector else 0.0, dmt.locate_dofs_geometrical(V, cs.y_planes), V)
        mpc = dmt.MultiPointConstraint(V, dtype, device=dev)
        mpc.create_periodic_constraint_geometrical(
            V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
        mpc.finalize()
        clf = dmt.assemble_matrix_lattice(form(V), mpc, bcs=[bc], dtype=dtype, side_format=side, device=dev)
        wl = {k: _coeff_vectors(clf.term, dev)[k][dm] for k, dm in clf._wdofmaps.items()}
        A_soa = clf._element_tensors(clf._coords, wl)
        A_cf = clf._cell_first_tensors(clf._coords, wl)
        rel = float((A_soa - A_cf).abs().max() / A_cf.abs().max())
        del A_soa, A_cf
        torch.cuda.synchronize()
        soa = cs.cuda_ms(lambda: clf._element_tensors(clf._coords, wl), 5, 1)
        cell_first = cs.cuda_ms(lambda: clf._cell_first_tensors(clf._coords, wl), 3, 1)
        return dict(cells=mesh.num_cells, soa_ms=soa, cell_first_ms=cell_first, rel=rel)

    def coefficient(V):
        kappa = dmt.Function(V, device=dev)
        kappa.interpolate(lambda x: 1.0 + x[0] * x[1])
        return dmt.BilinearForm(V, lambda u, v, c: c["kappa"].value * inner(grad(u), grad(v)),
                                coefficients={"kappa": kappa})

    def elasticity(V):
        return dmt.BilinearForm(V, lambda u, v, c: 2.0 * inner(sym(grad(u)), sym(grad(v)))
                                + 1.25 * div(u) * conj(div(v)))

    # the constant elasticity form assembles through K1 on "fold": its
    # element kernel runs on the "csr" format's real coordinates
    for name, form, vector, dtype, side, gate in (
            ("coefficient f64", coefficient, False, np.float64, "fold", 1e-12),
            ("coefficient f32", coefficient, False, np.float32, "fold", 5e-6),
            ("elasticity f64", elasticity, True, np.float64, "csr", 1e-12)):
        r = times(form, vector, dtype, side)
        print(json.dumps(dict(form=name, **r)), flush=True)
        if not r["rel"] <= gate:
            cs.fail(f"{name}: the SoA kernel differs from the cell-first one by {r['rel']:.3e}")


if __name__ == "__main__":
    main()
