"""The work of the degree-2 path's kernels, counted from the plain
reference's P2 stencil (reference/periodic_p2.py), not from the port, so
that a roofline reads the same work whatever implements it.

On the parity-blocked layout a point p = 2 q + c of the (2n+1)^3 grid is
class c in {0, 1}^3 of box q; a coupling of two P2 nodes of one tet is the
triple (row class, column class, coarse offset).  Every such triple over
the node pairs of the six Kuhn tets of a cube is stored, one value per box
of the padded class grids ((n+1)^3 boxes): 230 triples over 65 fine
offsets.  For the Laplacian 44 of them hold exact zeros (node pairs whose
gradients are orthogonal on every tet they share), which the kernels read
and write all the same."""

from portbench.yardstick import bound_ms


def stencil():
    """(triples, fine offsets): the distinct (row class, column class,
    coarse offset) triples, and the distinct offsets between two nodes,
    over all node pairs of each Kuhn tet."""
    from portbench.reference.periodic_p2 import p2_nodes

    triples, offsets = set(), set()
    for tet in p2_nodes():
        for a in tet:
            for b in tet:
                triples.add((tuple(a % 2), tuple(b % 2), tuple(b // 2 - a // 2)))
                offsets.add(tuple(b - a))
    return sorted(triples), sorted(offsets)


def couplings():
    """Stored values per box: the number of stencil triples."""
    return len(stencil()[0])


def boxes(n):
    """Boxes of the padded class grids at n cubes a side: ceil((2n+1)/2)^3."""
    return (n + 1) ** 3


def k6_bytes_flops(n, value_bytes=4):
    """K6, one blocked SpMV: every stored coupling read once, x and y over
    the 8-class stack once each; two operations per stored coupling."""
    stored = couplings() * boxes(n)
    return (stored + 2 * 8 * boxes(n)) * value_bytes, 2 * stored


def k4_bytes_flops(n, value_bytes=4):
    """K4, one assembly of the blocked operator: every stored coupling
    written once (its inputs, a per-plane table, are a small fraction)."""
    return couplings() * boxes(n) * value_bytes, 0
