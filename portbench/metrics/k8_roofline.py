"""K8's share in % of its bound: the device time per launch of the BELL
operator's product, from the profiler's trace of 20 launches after the
window, each after a read that evicts the L2 (core.kernel_trace), against
a float32 CSR of the nonzeros the reference's operator has, with int32
indices (yardstick)."""

from portbench.yardstick import csr_spmv_bytes_flops, kernel_ms, roofline_share

KERNEL = "bell_csr_matvec_kernel"


def read(rec):
    s = rec["sizes"]
    if s.get("nnz") is None:
        return None
    return roofline_share(kernel_ms(rec["probes"].get("k8"), KERNEL), *csr_spmv_bytes_flops(s["nnz"], s["dofs"]))
