"""periodic_p2 through the port's public API: the reference's canonical
run, P2 Poisson on Kuhn tets (periodic in x, Dirichlet on the y planes),
as bench.py runs degree 2: the fold lattice operator on the parity-class
stack (K4 assembles, K6 multiplies), GMG p-coarsened first and then
h-coarsened (bench.py:540-550) with blocked I/O, CG on the class stack,
backsubstitution.  The P1 levels are periodic_p1's form.

Each request solves A u = b for b = A x, x a field made from the run's
seed and the request's index (portbench.inputs.sine_field) on the reduced
rows of the (2n+1)^3 grid."""

import numpy as np
import torch

from portbench.core import load_module
from portbench.inputs import draw, sine_field

_lattice_form = load_module("configs", "periodic_p1")._lattice_form


def p2_levels(n, min_n):
    """bench.py:545-550's level list: P2 at n, P1 on the same grid (2n),
    then P1 halved while its size is even and at least min_n."""
    levels, m = [(2, n), (1, 2 * n)], n
    while m >= min_n and m % 2 == 0:
        levels.append((1, m))
        m //= 2
    return levels


class Problem:
    def __init__(self, cfg, traffic, seed, device, tracer):
        import dolfinx_mpc_tpu_torch as dmt
        from dolfinx_mpc_tpu_torch.ops.lattice import LatticeOperator

        if not hasattr(LatticeOperator, "to_blocked"):
            raise RuntimeError("periodic_p2 needs LatticeOperator.to_blocked / from_blocked, the port's public "
                               "conversions to and from the padded class stack")
        self.dmt, self.cfg, self.traffic, self.seed, self.device, self.tr = dmt, cfg, traffic, seed, device, tracer
        self.n = n = traffic["size"]["n"]
        dtype = np.dtype(cfg["dtype"])
        self.tdtype = getattr(torch, cfg["dtype"])
        p1 = {**cfg, **cfg["p1_levels"]}
        with tracer.setup_span("mesh_constraint_form"):
            self.mpc, self.clf = _lattice_form(dmt, n, cfg, dtype, device)
        pc = cfg["preconditioner"]
        with tracer.setup_span("pc_setup"):
            levels = p2_levels(n, pc["min_n"])
            # the finest level is the compiled form itself (bench.py's make_level)
            ops, masks = dmt.build_gmg_hierarchy(
                lambda lv: self.clf if lv == (2, n) else _lattice_form(dmt, lv[1], p1, dtype, device)[1],
                n, len(levels), levels=levels)
            self.M = dmt.LatticeGMG(ops, free_masks=masks, blocked_io=pc["blocked_io"], smoother=pc["smoother"],
                                    n_pre=pc["n_pre"], n_post=pc["n_post"], coarse=pc["coarse"])
        self.A = ops[0]
        self.levels = [[deg, list(o.dia.vshape)] for (deg, _), o in zip(levels, ops)]

    def request(self, k):
        """One solve on the class stack; ends in a synchronize.  Returns its
        outputs (b and u flat, in the grid's order)."""
        N, tr, s = 2 * self.n, self.tr, self.cfg["solver"]
        d = draw(self.traffic["draws"], self.seed, k)
        x = sine_field(d, N, self.device, self.tdtype)
        x[N] = 0  # the slave plane and the Dirichlet lines: off the reduced rows
        x[:, 0] = 0
        x[:, N] = 0
        with tr.span("request"):
            with tr.span("rhs"):
                b = self.A.matvec(x.reshape(-1))
                bb = self.A.to_blocked(b)
            with tr.span("cg"):
                xb, its, _ = self.dmt.cg(self.A.matvec_blocked, bb, M=tr.wrap("precond", self.M),
                                         rtol=s["rtol"], atol=s["atol"], max_it=s["max_it"])
            with tr.span("backsub"):
                u = self.mpc.finalized.backsubstitution(self.A.from_blocked(xb))
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        return {"its": its, "converged": its < s["max_it"], "inputs": d, "b": b, "u": u}

    def probes(self):
        """Kernels to trace alone after the window: K6, the fine operator's
        blocked product on the class stack, and K4, one reassembly of the
        fine operator."""
        xb = self.A.to_blocked(torch.ones(self.A.shape[0], dtype=self.tdtype, device=self.device))
        return {"k6": lambda: self.A.dia.matvec_blocked(xb), "k4": self.clf.assemble}

    def finish(self, kept):
        """The kept requests' outputs the reference judges."""
        return [{"k": k, "inputs": o["inputs"], "b": o["b"], "u": o["u"]} for k, o in kept]

    def describe(self):
        return {"dofs": (2 * self.n + 1) ** 3, "levels": self.levels, "coarse": self.M.coarse_mode,
                "boxes": int(np.prod(self.A.dia.cdims)), "couplings": len(self.A.dia.trips)}
