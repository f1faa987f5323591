"""The plain reference of `contact_tied`: linear elasticity on two stacked
P1 Kuhn-tet boxes, the top box's interface points tied to the bottom box's
interface triangles, u = 0 at z=0 and u = g at z=2.

The full stiffness is assembled from each tet's barycentric gradients as
two value arrays on one coalesced pattern, A(mu, lam) = mu A_mu + lam
A_lam.  The tie u = K x sets each slave dof (the top box's z=1 points, every
component) to the bottom box's P1 interpolant at its point: the bottom
box's z=1 triangles are the faces of its Kuhn tets there.  Dofs are
numbered 3 * point + component, the bottom box's points first, each box's
points lexicographic in (i, j, k)."""

import numpy as np
import torch

from portbench.reference import kuhn


def _triangles_on_top_face():
    """The (di, dj) corners of the Kuhn tets' faces on a cube's top face."""
    tris = []
    for tet in kuhn.kuhn_tets():
        top = [tuple(c[:2]) for c in tet if c[2] == 1]
        if len(top) == 3:
            tris.append(top)
    return np.asarray(tris, np.float64)  # (2, 3, 2)


class ContactTied:
    def __init__(self, cfg, traffic, device, dtype=torch.float64):
        nb, nt = traffic["size"]["nb"], traffic["size"]["nt"]
        if cfg["source_term"] != 0.0:
            raise ValueError("the reference takes the benchmark's zero source term")
        self.device, self.dtype = device, dtype
        pb, cb = kuhn.box((0, 0, 0), (1, 1, 1), (nb, nb, nb))
        pt, ct = kuhn.box((0, 0, 1), (1, 1, 2), (nt, nt, nt))
        nbot = (nb + 1) ** 3
        pts, cells = np.vstack([pb, pt]), np.vstack([cb, ct + nbot])
        self.N = N = 3 * len(pts)
        g, vol = kuhn.p1_gradients(pts[cells])
        dot = np.einsum("tad,tbd->tab", g, g)
        eye = np.eye(3)
        # test (a, i), trial (b, j): mu-part 2 eps:eps, lam-part div div
        kmu = vol[:, None, None, None, None] * (eye[None, None, :, None, :] * dot[:, :, None, :, None]
                                                 + np.einsum("taj,tbi->taibj", g, g))
        klam = vol[:, None, None, None, None] * np.einsum("tai,tbj->taibj", g, g)
        dof = (3 * cells[:, :, None] + np.arange(3)[None, None, :]).reshape(len(cells), 12)
        rows = np.broadcast_to(dof[:, :, None], (len(cells), 12, 12)).reshape(-1)
        cols = np.broadcast_to(dof[:, None, :], (len(cells), 12, 12)).reshape(-1)
        keys = torch.as_tensor(rows * N + cols, device=device)
        uniq, inv = torch.unique(keys, return_inverse=True)
        vals = torch.zeros((len(uniq), 2), dtype=torch.float64, device=device)
        vals.index_add_(0, inv, torch.as_tensor(np.stack([kmu.reshape(-1), klam.reshape(-1)], 1), device=device))
        self.rows, self.cols, self.vals = uniq // N, uniq % N, vals.to(dtype)
        # the tie: slaves the top box's z=1 points, masters the bottom box's
        tris = _triangles_on_top_face()
        slaves, masters, coeffs = [], [], []
        for i in range(nt + 1):
            for j in range(nt + 1):
                x, y = i / nt, j / nt
                ci, cj = min(int(np.floor(x * nb)), nb - 1), min(int(np.floor(y * nb)), nb - 1)
                s, t = x * nb - ci, y * nb - cj
                for tri in tris:
                    T = np.array([tri[1] - tri[0], tri[2] - tri[0]]).T
                    l12 = np.linalg.solve(T, np.array([s, t]) - tri[0])
                    lam = np.array([1 - l12.sum(), *l12])
                    if lam.min() >= -1e-9:
                        break
                else:
                    raise ValueError(f"slave point ({x}, {y}) lies in no interface triangle")
                mp = [((ci + int(di)) * (nb + 1) + cj + int(dj)) * (nb + 1) + nb for di, dj in tri]
                sp = nbot + (i * (nt + 1) + j) * (nt + 1)
                for c in range(3):
                    slaves.append(3 * sp + c)
                    masters.append([3 * m + c for m in mp])
                    coeffs.append(lam)
        as_t = lambda a, dt=torch.int64: torch.as_tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
        self.slaves, self.masters, self.coeffs = as_t(slaves), as_t(masters), as_t(coeffs, dtype)
        bottom = np.flatnonzero(np.isclose(pts[:, 2], 0.0))
        top = np.flatnonzero(np.isclose(pts[:, 2], 2.0))
        self.d_bottom = as_t((3 * bottom[:, None] + np.arange(3)).reshape(-1))
        self.d_top = as_t((3 * top[:, None] + np.arange(3)).reshape(-1))
        self.top_value = np.asarray(cfg["dirichlet"]["top"]["value"], np.float64)
        free = torch.ones(N, dtype=dtype, device=device)
        free[self.slaves] = 0
        free[self.d_bottom] = 0
        free[self.d_top] = 0
        self.free = free
        self.mu, self.lam = cfg["mu"], cfg["lambda"]

    def values(self, mu, lam):
        return mu * self.vals[:, 0] + lam * self.vals[:, 1]

    def A(self, vals, x):
        return torch.zeros_like(x).index_add_(0, self.rows, vals * x[self.cols])

    def norm_inf(self, vals):
        return float(torch.zeros(self.N, dtype=vals.dtype, device=vals.device)
                     .index_add_(0, self.rows, vals.abs()).max())

    def K(self, x):
        w = x.clone()
        w[self.slaves] = (self.coeffs * x[self.masters]).sum(dim=1)
        return w

    def Kt(self, y):
        r = y.clone()
        r.index_add_(0, self.masters.reshape(-1), (self.coeffs * y[self.slaves][:, None]).reshape(-1))
        r[self.slaves] = 0
        return r

    def g(self, scale):
        g = torch.zeros(self.N, dtype=self.dtype, device=self.device)
        g[self.d_top] = torch.as_tensor(np.tile(self.top_value * scale, len(self.d_top) // 3), dtype=self.dtype,
                                        device=self.device)
        return g

    def rhs(self, vals, g):
        """The constrained right-hand side: -K^T A g on the free rows, g on
        the Dirichlet rows, 0 on the slave rows."""
        b = -self.Kt(self.A(vals, g)) * self.free
        return b + g

    def op(self, vals, v):
        """The constrained operator's action: K^T A K on the free rows and
        columns, the identity on the Dirichlet and slave rows."""
        return self.Kt(self.A(vals, self.K(v * self.free))) * self.free + v * (1 - self.free)

    def residual(self, vals, g, u):
        """The residual of a full solution u (slave and Dirichlet values
        included) in the constrained system with Dirichlet values g and no
        source: -K^T A u on the free rows, g - u on the Dirichlet rows and
        the tie's K u - u on the slave rows."""
        r = -self.Kt(self.A(vals, u)) * self.free
        d = torch.cat([self.d_bottom, self.d_top])
        r[d] = g[d] - u[d]
        r[self.slaves] = self.K(u)[self.slaves] - u[self.slaves]
        return r

    def nnz(self):
        """Entries of the constrained operator that are not exactly zero."""
        import scipy.sparse as sp

        N = self.N
        A = sp.csr_matrix((self.values(self.mu, self.lam).double().cpu().numpy(),
                           (self.rows.cpu().numpy(), self.cols.cpu().numpy())), shape=(N, N))
        s, m, c = (t.cpu().numpy() for t in (self.slaves, self.masters, self.coeffs.double()))
        keep = np.setdiff1d(np.arange(N), s)
        K = sp.coo_matrix((np.ones(len(keep)), (keep, keep)), shape=(N, N)).tocsr()
        K = K + sp.csr_matrix((c.reshape(-1), (np.repeat(s, m.shape[1]), m.reshape(-1))), shape=(N, N))
        free = sp.diags(self.free.double().cpu().numpy())
        Ah = free @ (K.T @ A @ K) @ free + sp.diags(1.0 - self.free.double().cpu().numpy())
        Ah = sp.csr_matrix(Ah)
        Ah.eliminate_zeros()
        return int(Ah.nnz)

    def solve(self, vals, g, rtol=1e-12, max_it=100000):
        """u = K x + g with x the Jacobi-CG solution of the constrained
        system on the free dofs, in this reference's dtype."""
        b = self.rhs(vals, g) * self.free
        d = torch.zeros(self.N, dtype=vals.dtype, device=vals.device)
        d.index_add_(0, self.rows, torch.where(self.rows == self.cols, vals, torch.zeros_like(vals)))
        dinv = self.free / torch.where(self.free > 0, d, torch.ones_like(d))
        x = torch.zeros_like(b)
        r = b.clone()
        z = dinv * r
        p, rz = z, torch.dot(r, z)
        tol = rtol * float(torch.linalg.vector_norm(b))
        for _ in range(max_it):
            if float(torch.linalg.vector_norm(r)) <= tol:
                return self.K(x) + g
            Ap = self.op(vals, p) * self.free
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = dinv * r
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        raise RuntimeError("the reference's Jacobi-CG did not converge")


def _params(cfg, traffic, inputs):
    mu = cfg["mu"] * inputs.get("mu_scale", 1.0)
    lam = cfg["lambda"] * inputs.get("lam_scale", 1.0)
    return mu, lam, inputs["top_scale"]


def judge(cfg, traffic, seed, kept, device, dtype=torch.float64):
    """The numbers compared, each the worst over the kept requests:
    op_gap        |A v - Ah v|_inf / (|A|_inf |v|_inf), the operator the
                  request solved with (its own where it reassembles) on a
                  seeded v, Ah the reference's constrained operator;
    rhs_gap       |b - bh|_inf / (|A|_inf |g|_inf + |bh|_inf);
    backward_err  |r|_inf / (max(|A|_inf, 1) |u|_inf + |bh|_inf), u the
                  solution after backsubstitution and r its residual in the
                  constrained system: the free rows' -K^T A u, the Dirichlet
                  rows' g - u, the slave rows' (K u) - u;
    rel_res       |r|_2 / |bh|_2: the relative residual CG's rtol bounds, of
                  the solution in this reference's system."""
    from portbench.inputs import probe_vector

    ref = ContactTied(cfg, traffic, device, dtype)
    op_gap = rhs_gap = backward_err = rel_res = 0.0
    for s in kept:
        mu, lam, scale = _params(cfg, traffic, s["inputs"])
        vals = ref.values(mu, lam)
        a_inf = ref.norm_inf(vals)
        v = probe_vector(seed, s["k"], ref.N, device, dtype)
        op_gap = max(op_gap, float((s["Av"].to(dtype) - ref.op(vals, v)).abs().max()) / (a_inf * float(v.abs().max())))
        g = ref.g(scale)
        bh = ref.rhs(vals, g)
        b_inf = float(bh.abs().max())
        rhs_gap = max(rhs_gap, float((s["b"].to(dtype) - bh).abs().max()) / (a_inf * float(g.abs().max()) + b_inf))
        u = s["u"].to(dtype)
        r = ref.residual(vals, g, u)
        backward_err = max(backward_err, float(r.abs().max()) / (max(a_inf, 1.0) * float(u.abs().max()) + b_inf))
        rel_res = max(rel_res, float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(bh)))
    return ({"op_gap": op_gap, "rhs_gap": rhs_gap, "backward_err": backward_err, "rel_res": rel_res},
            {"nnz": ref.nnz(), "dofs": ref.N})


def control(cfg, traffic, seed, ks, device):
    """The reference in the program's place: the operator's action and the
    right-hand side computed in the precision below the assembly's (float32
    for float64), the solution as the float64 reference solution rounded to
    the precision below the solve's (bfloat16 for float32: the closest
    answer it holds)."""
    from portbench.inputs import draw, probe_vector
    from portbench.reference.precision import lower

    dtype, solve_dtype = lower(cfg["assembly_dtype"]), lower(cfg["dtype"])
    lo = ContactTied(cfg, traffic, device, dtype)
    hi = ContactTied(cfg, traffic, device, torch.float64)
    out = []
    for k in ks:
        d = draw(traffic["draws"], seed, k)
        mu, lam, scale = _params(cfg, traffic, d)
        v = probe_vector(seed, k, lo.N, device, dtype)
        u = hi.solve(hi.values(mu, lam), hi.g(scale)).to(solve_dtype)
        out.append({"k": k, "inputs": d, "Av": lo.op(lo.values(mu, lam), v),
                    "b": lo.rhs(lo.values(mu, lam), lo.g(scale)), "u": u})
    return out
