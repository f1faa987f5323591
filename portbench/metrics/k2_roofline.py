"""K2's share in % of its bound: the device time per launch of the fine
operator's DIA product, from the profiler's trace of 20 launches after the
window, each after a read that evicts the L2 (core.kernel_trace), against
the bytes of the P1 Kuhn stencil's stored diagonals, x and y at float32
(yardstick)."""

from portbench.yardstick import dia_spmv_bytes_flops, kernel_ms, roofline_share

KERNEL = "dia_matvec_kernel"


def read(rec):
    points = rec["sizes"].get("points")
    if points is None:
        return None
    return roofline_share(kernel_ms(rec["probes"].get("k2"), KERNEL), *dia_spmv_bytes_flops(points))
