"""contact_tied through the port's public API: two stacked P1 vector tet
boxes tied by create_contact_inelastic_condition(mt, 1, 2), linear
elasticity, Dirichlet at z=0 and z=2; the constraint and the assembly in
float64 on the card, A.to_scipy() -> bell_from_scipy in float32 (K8),
smoothed-aggregation AMG in float32 with the rigid-body near-nullspace, CG,
backsubstitution.

A traffic with "reassemble" true scales the Lame parameters and the top
displacement per request and reassembles the matrix, the right-hand side
and the BELL operator, under the AMG of the set-up's operator (a lagged
preconditioner); otherwise only the top displacement changes, and each
request assembles its right-hand side and solves on the set-up's operator."""

import numpy as np
import torch

from portbench.inputs import draw


def contact_mesh(dmt, nb, nt):
    """The stacked boxes (0,0,0)-(1,1,1) with nb^3 and (0,0,1)-(1,1,2) with
    nt^3 cubes in one mesh, the interface facets tagged 1 on the top box's
    side and 2 on the bottom box's."""
    from dolfinx_mpc_tpu_torch.fem.mesh import Mesh, create_box, meshtags

    bot = create_box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
    top = create_box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
    mesh = Mesh(np.vstack([bot.points, top.points]), np.vstack([bot.cells, top.cells + bot.num_points]),
                bot.cell_type)
    fverts, _, f2c = mesh.facets()
    fpts = mesh.points[fverts]
    ext = np.isin(np.arange(fverts.shape[0]), mesh.exterior_facets())
    iface = np.flatnonzero(np.isclose(fpts[:, :, 2], 1.0).all(axis=1) & ext)
    cz = mesh.points[mesh.cells[f2c[iface, 0]]].mean(axis=1)[:, 2]
    return mesh, meshtags(mesh, 2, iface, np.where(cz > 1.0, 1, 2))


class Problem:
    def __init__(self, cfg, traffic, seed, device, tracer):
        import dolfinx_mpc_tpu_torch as dmt
        from dolfinx_mpc_tpu_torch.fem.forms import conj, div, grad, inner, sym
        from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
        from dolfinx_mpc_tpu_torch.la.bell import bell_from_scipy
        from dolfinx_mpc_tpu_torch.utils.mpc_utils import rigid_motions_nullspace

        self.dmt, self.cfg, self.traffic, self.seed, self.device, self.tr = dmt, cfg, traffic, seed, device, tracer
        self.bell_from_scipy = bell_from_scipy
        self.dtype = np.dtype(cfg["dtype"])
        self.reassemble = traffic["reassemble"]
        nb, nt = traffic["size"]["nb"], traffic["size"]["nt"]
        adt = np.dtype(cfg["assembly_dtype"])
        with tracer.setup_span("mesh_constraint_form"):
            mesh, mt = contact_mesh(dmt, nb, nt)
            V = dmt.functionspace(mesh, tuple(cfg["element"][:2]) + (tuple(cfg["element"][2]),))
            self.mpc = dmt.MultiPointConstraint(V, adt, device=device)
            self.mpc.create_contact_inelastic_condition(mt, cfg["constraint"]["slave"], cfg["constraint"]["master"])
            self.mpc.finalize()
            d = cfg["dirichlet"]
            self.bc_top = dmt.dirichletbc(np.asarray(d["top"]["value"], np.float64),
                                          dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 2.0)), V)
            self.bcs = [dmt.dirichletbc(np.asarray(d["bottom"]["value"], np.float64),
                                        dmt.locate_dofs_geometrical(V, lambda x: np.isclose(x[2], 0.0)), V),
                        self.bc_top]
            # the Lame parameters are constants of the form: a request sets them
            # in place, as a Newton loop updates its coefficients
            self.constants = {"mu": cfg["mu"], "lam": cfg["lambda"]}
            self.a = dmt.BilinearForm(V, lambda u, v, c: 2 * c["mu"] * inner(sym(grad(u)), sym(grad(v)))
                                      + c["lam"] * div(u) * conj(div(v)), constants=self.constants)
            f = cfg["source_term"]
            self.L = dmt.LinearForm(V, lambda v, c: f * v.value[..., 2])
        with tracer.setup_span("assemble"):
            self.A = dmt.assemble_matrix(self.a, self.mpc, self.bcs)
        with tracer.setup_span("bell_convert"):
            As = self.A.to_scipy()
            self.B = bell_from_scipy(As, dtype=self.dtype, device=device)
        with tracer.setup_span("pc_setup"):
            self.M = smoothed_aggregation_amg(As, bs=3, dtype=self.dtype, nullspace=rigid_motions_nullspace(V),
                                              device=device)
        self.dofs = V.num_dofs
        self.levels = [tuple(o.shape) for o in self.M.ops]
        self.top = np.asarray(d["top"]["value"], np.float64)

    def request(self, k):
        """One solve; ends in a synchronize.  Returns its outputs."""
        dmt, tr, s = self.dmt, self.tr, self.cfg["solver"]
        d = draw(self.traffic["draws"], self.seed, k)
        self.bc_top.value = self.top * d["top_scale"]
        out = {"inputs": d}
        with tr.span("request"):
            if self.reassemble:
                self.constants["mu"] = self.cfg["mu"] * d["mu_scale"]
                self.constants["lam"] = self.cfg["lambda"] * d["lam_scale"]
                with tr.span("assemble"):
                    A = dmt.assemble_matrix(self.a, self.mpc, self.bcs)
                    b = self._rhs()
                with tr.span("bell_convert"):
                    B = self.bell_from_scipy(A.to_scipy(), dtype=self.dtype, device=self.device)
                out["A"] = A
            else:
                with tr.span("rhs"):
                    b = self._rhs()
                B = self.B
            with tr.span("cg"):
                x, its, _ = dmt.cg(B.matvec, b.to(getattr(torch, self.dtype.name)), M=tr.wrap("precond", self.M),
                                   rtol=s["rtol"], atol=s["atol"], max_it=s["max_it"])
            with tr.span("backsub"):
                u = self.mpc.finalized.backsubstitution(x)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        out.update(its=its, converged=its < s["max_it"], b=b, u=u)
        return out

    def _rhs(self):
        dmt = self.dmt
        return dmt.set_bc(dmt.apply_lifting(dmt.assemble_vector(self.L, self.mpc), [self.a], [self.bcs], self.mpc),
                          self.bcs)

    def probes(self):
        """Kernels to trace alone after the window: K8, the BELL operator's
        product."""
        v = torch.ones(self.dofs, dtype=getattr(torch, self.dtype.name), device=self.device)
        return {"k8": lambda: self.B.matvec(v)}

    def finish(self, kept):
        """The kept requests' outputs the reference judges: the right-hand
        side, the solution, and the operator's action on a seeded vector
        (each request's own operator where it reassembles, else the
        set-up's)."""
        from portbench.inputs import probe_vector

        out = []
        for k, o in kept:
            A = o.get("A", self.A)
            v = probe_vector(self.seed, k, self.dofs, self.device, torch.float64)
            out.append({"k": k, "inputs": o["inputs"], "b": o["b"], "u": o["u"], "Av": A.matvec(v)})
        return out

    def describe(self):
        return {"dofs": self.dofs, "amg_levels": self.levels}
