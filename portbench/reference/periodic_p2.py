"""The plain reference of `periodic_p2`: -Laplace on P2 Kuhn tets of the
unit cube with n cubes a side, periodic in x (the x=1 plane tied to x=0),
u = 0 on y=0 and y=1.

The P2 nodes of the mesh are the points of the (2n+1)^3 grid (x index
slowest): cube (i, j, k) holds the 27 points 2 (i, j, k) + o, o in {0, 1,
2}^3, and each of its six tets ten of them (four corners, six edge
midpoints).  The stiffness of one cube, the sum of its six tets' 10 x 10
P2 matrices, is computed exactly: on an affine tet the gradients of the P2
basis are linear in the barycentric coordinates, so the integrand is a
quadratic in them, integrated by the closed form of the integrals of
lambda_k and lambda_k lambda_l.  The matrix is applied matrix-free by one
stride-2 shifted-slice product per nonzero entry.  The constraint and the
reduced rows are reference/periodic_p1.py's (its fold and unfold): u = K x
copies the x=0 plane into the slave plane; K^T adds the slave plane's rows
into x=0; Dirichlet and slave rows are left out of the reduced system."""

import numpy as np
import torch

from portbench.reference import kuhn
from portbench.reference.periodic_p1 import PeriodicP1, field as p1_field


def p2_nodes():
    """(6, 10, 3) int: each Kuhn tet's P2 nodes as offsets in {0, 1, 2}^3
    from its cube's first point on the grid of half steps: the four corners
    (twice the corner offsets), then the edge midpoints (0,1), (0,2),
    (0,3), (1,2), (1,3), (2,3)."""
    c = kuhn.kuhn_tets()  # (6, 4, 3)
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    return np.concatenate([2 * c, np.stack([c[:, a] + c[:, b] for a, b in edges], axis=1)], axis=1)


def _p2_stiffness(x):
    """The exact 10 x 10 P2 stiffness of the tet with vertices x (4, 3),
    node order of p2_nodes.  grad phi = sum_k lambda_k G[k] + G0 with
    vertex phi_i = lambda_i (2 lambda_i - 1): G[i] = 4 g_i, G0 = -g_i, and
    edge phi_ij = 4 lambda_i lambda_j: G[i] = 4 g_j, G[j] = 4 g_i; then
    int lambda_k lambda_l = V (1 + delta_kl) / 20, int lambda_k = V / 4."""
    g, vol = kuhn.p1_gradients(x[None])
    g, vol = g[0], float(vol[0])
    G = np.zeros((10, 4, 3))
    G0 = np.zeros((10, 3))
    for i in range(4):
        G[i, i] = 4.0 * g[i]
        G0[i] = -g[i]
    for m, (i, j) in enumerate([(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]):
        G[4 + m, i] = 4.0 * g[j]
        G[4 + m, j] = 4.0 * g[i]
    mll = vol * (np.ones((4, 4)) + np.eye(4)) / 20.0
    ml = np.full(4, vol / 4.0)
    return (np.einsum("akd,kl,bld->ab", G, mll, G) + np.einsum("akd,k,bd->ab", G, ml, G0)
            + np.einsum("ad,k,bkd->ab", G0, ml, G) + vol * G0 @ G0.T)


def cube_matrix(n):
    """(27, 27) float64: the stiffness of one cube of side 1/n, the sum of
    its six Kuhn tets' P2 matrices, rows and columns by local point o0 * 9
    + o1 * 3 + o2."""
    corner = kuhn.kuhn_tets().astype(np.float64) / n
    nodes = p2_nodes()
    lid = nodes[..., 0] * 9 + nodes[..., 1] * 3 + nodes[..., 2]  # (6, 10)
    hexm = np.zeros((27, 27))
    for t in range(6):
        hexm[np.ix_(lid[t], lid[t])] += _p2_stiffness(corner[t])
    return hexm


def local_offset(a):
    return np.array([a // 9, (a // 3) % 3, a % 3])


class PeriodicP2(PeriodicP1):
    """PeriodicP1's fold, unfold and right-hand side on the (2n+1)^3 grid
    (self.n = 2n intervals a side), with the P2 cube matrix applied by
    stride-2 slices."""

    def __init__(self, n, device, dtype=torch.float64):
        self.cubes, self.n, self.device, self.dtype = n, 2 * n, device, dtype
        hexm = cube_matrix(n)
        self.entries = [(a, b, float(hexm[a, b])) for a in range(27) for b in range(27) if hexm[a, b] != 0.0]
        N = self.n
        self.norm_inf = float(self._apply(torch.ones((N + 1,) * 3, dtype=torch.float64, device=device),
                                          absolute=True).max())
        keep = torch.ones((N + 1,) * 3, dtype=dtype, device=device)
        keep[N] = 0  # the slave plane (its Dirichlet lines too)
        keep[:, 0] = 0
        keep[:, N] = 0
        self.keep = keep

    def _slice(self, a):
        o = local_offset(a)
        return tuple(slice(int(o[d]), int(o[d]) + 2 * self.cubes, 2) for d in range(3))


def field(inputs, n, device, dtype):
    """The request's exact solution on the reduced rows of the (2n+1)^3
    grid: periodic_p1's field on 2n intervals a side."""
    return p1_field(inputs, 2 * n, device, dtype)


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
    ref = PeriodicP2(n, device, dtype)
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
    return {"rhs_gap": rhs_gap, "fwd_err": fwd_err, "rel_res": rel_res}, {"points": (2 * n + 1) ** 3}


def control(cfg, traffic, seed, ks, device):
    """The reference in the program's place in the precision below the
    configuration's (bfloat16 for float32): each request's right-hand side
    applied in it to x in it, and its solution K x rounded to it (the
    closest answer it holds)."""
    from portbench.inputs import draw
    from portbench.reference.precision import lower

    dtype = lower(cfg["dtype"])
    n = traffic["size"]["n"]
    ref = PeriodicP2(n, device, dtype)
    out = []
    for k in ks:
        d = draw(traffic["draws"], seed, k)
        x = field(d, n, device, dtype)
        out.append({"k": k, "inputs": d, "b": ref.rhs(x).reshape(-1),
                    "u": ref.unfold(field(d, n, device, torch.float64)).to(dtype).reshape(-1)})
    return out
