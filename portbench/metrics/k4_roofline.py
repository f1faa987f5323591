"""K4's share in % of its bound: the device time per launch of one
reassembly of the fine P2 operator, from the profiler's trace of 20
launches after the window, each after a read that evicts the L2
(core.kernel_trace), against the P2 stencil's stored couplings written once
at float32 (yardstick_p2: counted from the reference's stencil)."""

from portbench.yardstick import kernel_ms, roofline_share
from portbench.yardstick_p2 import k4_bytes_flops

KERNEL = "fold_assemble_kernel"


def read(rec):
    return roofline_share(kernel_ms(rec["probes"].get("k4"), KERNEL), *k4_bytes_flops(rec["traffic"]["size"]["n"]))
