"""The card's peaks and the roofline arithmetic the per-layer readers use.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit: HBM3 at
3.35 TB/s and 67 TFLOP/s in float32 outside the tensor cores.  A bound
counts each input byte read once and each output byte written once."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_ms(nbytes, flops):
    """The least time in ms the card can take for work that moves `nbytes`
    through HBM and does `flops` float32 operations."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def kernel_ms(probe, kernel):
    """Mean device ms per launch of the kernels whose name holds `kernel`,
    in a probe's trace ({name: [device seconds, launches]}), or None where
    the probe did not run or launched no such kernel."""
    hits = [v for name, v in (probe or {}).items() if kernel in name]
    launches = sum(c for _, c in hits)
    return 1e3 * sum(s for s, _ in hits) / launches if launches else None


def roofline_share(ms, nbytes, flops):
    """Share in % of the bound achieved in `ms` per launch, or None where
    there is no time."""
    if not ms:
        return None
    return 100.0 * bound_ms(nbytes, flops) / ms


def kuhn_stencil_offsets():
    """The lattice offsets between two vertices of one tet of the Kuhn split
    of a cube, the stored diagonals of a P1 operator on such a mesh, the
    centre included."""
    from portbench.reference.kuhn import kuhn_tets

    return sorted({tuple(b - a) for tet in kuhn_tets() for a in tet for b in tet})


def dia_spmv_bytes_flops(points, bs=1, value_bytes=4):
    """Bytes and operations of one DIA SpMV on a P1 Kuhn lattice of `points`
    grid points with `bs` components: every stored diagonal (bs x bs values
    per offset and point) read once, x read once, y written once."""
    n_off = len(kuhn_stencil_offsets())
    stored = n_off * bs * bs * points
    return (stored + 2 * bs * points) * value_bytes, 2 * stored


def csr_spmv_bytes_flops(nnz, rows, value_bytes=4, index_bytes=4):
    """Bytes and operations of one CSR SpMV of a square matrix with `nnz`
    nonzeros: values and column indices once, row pointers once, x read
    once, y written once."""
    return nnz * (value_bytes + index_bytes) + (rows + 1) * index_bytes + 2 * rows * value_bytes, 2 * nnz
