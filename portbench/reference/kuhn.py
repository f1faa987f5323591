"""P1 tetrahedra of the Kuhn split of a box: six tets per cube, one per
order in which the three axes are stepped from the cube's first corner to
its last (dolfinx's create_box "tet" split)."""

from itertools import permutations

import numpy as np


def kuhn_tets():
    """(6, 4, 3) int: the corner offsets (di, dj, dk) of each tet."""
    tets = []
    for perm in permutations(range(3)):
        c = [0, 0, 0]
        path = [tuple(c)]
        for ax in perm:
            c[ax] += 1
            path.append(tuple(c))
        tets.append(path)
    return np.asarray(tets, np.int64)


def box(p0, p1, n):
    """Points (lexicographic in (i, j, k), x slowest) and Kuhn tets of the
    box p0-p1 with n = (nx, ny, nz) cubes."""
    nx, ny, nz = n
    axes = [np.linspace(p0[d], p1[d], n[d] + 1) for d in range(3)]
    I, J, K = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1), np.arange(nz + 1), indexing="ij")
    pts = np.stack([axes[0][I.ravel()], axes[1][J.ravel()], axes[2][K.ravel()]], axis=1)
    ci, cj, ck = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    base = np.stack([ci.ravel(), cj.ravel(), ck.ravel()], axis=1)  # (cubes, 3)
    corners = base[:, None, None, :] + kuhn_tets()[None]  # (cubes, 6, 4, 3)
    vid = (corners[..., 0] * (ny + 1) + corners[..., 1]) * (nz + 1) + corners[..., 2]
    return pts, vid.reshape(-1, 4)


def p1_gradients(x):
    """Barycentric gradients (T, 4, 3) and volumes (T,) of tets with vertex
    coordinates x (T, 4, 3)."""
    J = np.stack([x[:, 1] - x[:, 0], x[:, 2] - x[:, 0], x[:, 3] - x[:, 0]], axis=1)  # rows: edges
    inv = np.linalg.inv(J)  # lambda_{1..3} = inv^T-rows: grad lambda_i = inv[:, :, i-1]
    g = np.empty_like(x)
    g[:, 1:] = np.transpose(inv, (0, 2, 1))
    g[:, 0] = -g[:, 1:].sum(axis=1)
    return g, np.abs(np.linalg.det(J)) / 6.0
