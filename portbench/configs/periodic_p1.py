"""periodic_p1 through the port's public API: bench.py's P1 problem
(periodic in x, Dirichlet on the y planes), the fold lattice operator (K1
assembles, K2 multiplies), GMG by bench.py's rule, CG, backsubstitution.

Each request solves A u = b for b = A x, x a field made from the run's
seed and the request's index (portbench.inputs.sine_field) on the reduced
rows."""

import numpy as np
import torch

from portbench.inputs import draw, sine_field


def _y_planes(x):
    return np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)


def _lattice_form(dmt, m, cfg, dtype, device):
    from dolfinx_mpc_tpu_torch.fem.forms import grad, inner
    from dolfinx_mpc_tpu_torch.fem.mesh import create_unit_cube

    V = dmt.functionspace(create_unit_cube(m, m, m), tuple(cfg["element"]))
    bc = dmt.dirichletbc(cfg["dirichlet"]["value"], dmt.locate_dofs_geometrical(V, _y_planes), V)
    mpc = dmt.MultiPointConstraint(V, dtype, device=device)
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = dmt.BilinearForm(V, lambda u, v, c: inner(grad(u), grad(v)), quad_degree=cfg["quad_degree"])
    op = cfg["operator"]
    clf = dmt.assemble_matrix_lattice(a, mpc, bcs=[bc], diagval=op["diagval"], dtype=dtype,
                                      side_format=op["side_format"], device=device)
    return mpc, clf


class Problem:
    def __init__(self, cfg, traffic, seed, device, tracer):
        import dolfinx_mpc_tpu_torch as dmt

        self.dmt, self.cfg, self.traffic, self.seed, self.device, self.tr = dmt, cfg, traffic, seed, device, tracer
        self.n = n = traffic["size"]["n"]
        dtype = np.dtype(cfg["dtype"])
        self.tdtype = getattr(torch, cfg["dtype"])
        with tracer.setup_span("mesh_constraint_form"):
            self.mpc, clf = _lattice_form(dmt, n, cfg, dtype, device)
        pc = cfg["preconditioner"]
        with tracer.setup_span("pc_setup"):
            # the finest level is the compiled form itself (bench.py's make_level)
            ops, masks = dmt.build_gmg_hierarchy(
                lambda m: clf if m == n else _lattice_form(dmt, m, cfg, dtype, device)[1],
                n, pc["levels"], min_n=pc["min_n"])
            self.M = dmt.LatticeGMG(ops, free_masks=masks, smoother=pc["smoother"], n_pre=pc["n_pre"],
                                    n_post=pc["n_post"], coarse=pc["coarse"])
        self.A = ops[0]
        self.levels = [tuple(o.dia.vshape) for o in ops]

    def request(self, k):
        """One solve; ends in a synchronize.  Returns its outputs."""
        n, tr, s = self.n, self.tr, self.cfg["solver"]
        d = draw(self.traffic["draws"], self.seed, k)
        x = sine_field(d, n, self.device, self.tdtype)
        x[n] = 0  # the slave plane and the Dirichlet lines: off the reduced rows
        x[:, 0] = 0
        x[:, n] = 0
        with tr.span("request"):
            with tr.span("rhs"):
                b = self.A.matvec(x.reshape(-1))
            with tr.span("cg"):
                xs, its, _ = self.dmt.cg(self.A.matvec, b, M=tr.wrap("precond", self.M), rtol=s["rtol"],
                                         atol=s["atol"], max_it=s["max_it"])
            with tr.span("backsub"):
                u = self.mpc.finalized.backsubstitution(xs)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        return {"its": its, "converged": its < s["max_it"], "inputs": d, "b": b, "u": u}

    def probes(self):
        """Kernels to trace alone after the window: K2, the fine operator's
        DIA product."""
        v = torch.ones(self.A.dia.shape[0], dtype=self.tdtype, device=self.device)
        return {"k2": lambda: self.A.dia.matvec(v)}

    def finish(self, kept):
        """The kept requests' outputs the reference judges."""
        return [{"k": k, "inputs": o["inputs"], "b": o["b"], "u": o["u"]} for k, o in kept]

    def describe(self):
        return {"dofs": (self.n + 1) ** 3, "levels": self.levels, "coarse": self.M.coarse_mode}
