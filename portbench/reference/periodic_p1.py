"""The plain reference of `periodic_p1`: -Laplace on P1 Kuhn tets of the
unit cube with n cubes a side, periodic in x (the x=1 plane tied to x=0),
u = 0 on y=0 and y=1.

The stiffness of the whole mesh is applied matrix-free on the (n+1)^3 grid
of points (x index slowest): every cube is a translate of one cube, whose
8 x 8 matrix (the sum of its six tets' P1 stiffness) is applied by one
shifted-slice product per nonzero entry.  The constraint u = K x copies the
x=0 plane into the slave plane; K^T adds the slave plane's rows into x=0;
Dirichlet and slave rows are left out of the reduced system."""

import numpy as np
import torch

from portbench.reference import kuhn


class PeriodicP1:
    def __init__(self, n, device, dtype=torch.float64):
        self.n, self.device, self.dtype = n, device, dtype
        corner = kuhn.kuhn_tets()  # (6, 4, 3)
        g, vol = kuhn.p1_gradients(corner.astype(np.float64) / n)
        hexm = np.zeros((8, 8))
        cid = corner[..., 0] + 2 * corner[..., 1] + 4 * corner[..., 2]  # (6, 4)
        for t in range(6):
            ke = vol[t] * g[t] @ g[t].T
            for a in range(4):
                for b in range(4):
                    hexm[cid[t, a], cid[t, b]] += ke[a, b]
        self.entries = [(a, b, float(hexm[a, b])) for a in range(8) for b in range(8) if hexm[a, b] != 0.0]
        self.norm_inf = float(self._apply(torch.ones((n + 1,) * 3, dtype=torch.float64, device=device),
                                          absolute=True).max())
        keep = torch.ones((n + 1,) * 3, dtype=dtype, device=device)
        keep[n] = 0  # the slave plane (its Dirichlet lines too)
        keep[:, 0] = 0
        keep[:, n] = 0
        self.keep = keep

    def _slice(self, c):
        n = self.n
        di, dj, dk = c & 1, (c >> 1) & 1, (c >> 2) & 1
        return (slice(di, di + n), slice(dj, dj + n), slice(dk, dk + n))

    def _apply(self, u, absolute=False):
        y = torch.zeros_like(u)
        for a, b, v in self.entries:
            y[self._slice(a)] += (abs(v) if absolute else v) * u[self._slice(b)]
        return y

    def unfold(self, u):
        """u = K x: the slave plane (x=1, off the Dirichlet lines) copies x=0."""
        u = u.clone()
        u[self.n, 1:self.n] = u[0, 1:self.n]
        return u

    def fold(self, y):
        """K^T y on the reduced rows (Dirichlet and slave rows zero)."""
        y = y.clone()
        y[0, 1:self.n] += y[self.n, 1:self.n]
        return y * self.keep

    def grid(self, v):
        return v.reshape((self.n + 1,) * 3).to(self.dtype)

    def rhs(self, x):
        """K^T A K x for a reduced field x (zero off the reduced rows)."""
        return self.fold(self._apply(self.unfold(x * self.keep)))


def field(inputs, n, device, dtype):
    """The request's exact solution on the reduced rows: the sine modes
    drawn for it, zero on the Dirichlet and slave rows."""
    from portbench.inputs import sine_field

    u = sine_field(inputs, n, device, torch.float64)
    u[n] = 0
    u[:, 0] = 0
    u[:, n] = 0
    return u.to(dtype)


def judge(cfg, traffic, seed, kept, device, dtype=torch.float64):
    """The numbers compared, each the worst over the kept requests:
    rhs_gap   |b - K^T A K x|_inf / (|A|_inf |x|_inf), b the right-hand side
              the timed path made from x (the operator's action);
    fwd_err   |u - K x|_2 / |K x|_2, u the solution after backsubstitution,
              x the request's exact solution (b = A x is manufactured);
    rel_res   |K^T A K (x - u)|_2 / |K^T A K x|_2 on the reduced rows: the
              relative residual CG's rtol bounds, of the solution in this
              reference's system."""
    n = traffic["size"]["n"]
    ref = PeriodicP1(n, device, dtype)
    rhs_gap = fwd_err = rel_res = 0.0
    for s in kept:
        x = field(s["inputs"], n, device, dtype)
        b_ref = ref.rhs(x)
        b = ref.grid(s["b"])
        rhs_gap = max(rhs_gap, float((b - b_ref).abs().max()) / (ref.norm_inf * float(x.abs().max())))
        u_ref = ref.unfold(x)
        u = ref.grid(s["u"])
        fwd_err = max(fwd_err, float(torch.linalg.vector_norm(u - u_ref) / torch.linalg.vector_norm(u_ref)))
        rel_res = max(rel_res, float(torch.linalg.vector_norm(b_ref - ref.rhs(u)) / torch.linalg.vector_norm(b_ref)))
        del b, b_ref, u, u_ref
    return {"rhs_gap": rhs_gap, "fwd_err": fwd_err, "rel_res": rel_res}, {"points": (n + 1) ** 3}


def control(cfg, traffic, seed, ks, device):
    """The reference in the program's place in the precision below the
    configuration's (bfloat16 for float32): each request's right-hand side
    applied in it to x in it, and its solution K x rounded to it (the
    closest answer it holds)."""
    from portbench.inputs import draw
    from portbench.reference.precision import lower

    dtype = lower(cfg["dtype"])
    n = traffic["size"]["n"]
    ref = PeriodicP1(n, device, dtype)
    out = []
    for k in ks:
        d = draw(traffic["draws"], seed, k)
        x = field(d, n, device, dtype)
        out.append({"k": k, "inputs": d, "b": ref.rhs(x).reshape(-1),
                    "u": ref.unfold(field(d, n, device, torch.float64)).to(dtype).reshape(-1)})
    return out
