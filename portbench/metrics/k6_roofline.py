"""K6's share in % of its bound: the device time per launch of the fine
operator's blocked product on the class stack, from the profiler's trace of
20 launches after the window, each after a read that evicts the L2
(core.kernel_trace), against the bytes of the P2 stencil's stored couplings
and of x and y over the 8-class stack at float32 (yardstick_p2: counted
from the reference's stencil, not from the port)."""

from portbench.yardstick import kernel_ms, roofline_share
from portbench.yardstick_p2 import k6_bytes_flops

KERNEL = "blocked_matvec_kernel"


def read(rec):
    return roofline_share(kernel_ms(rec["probes"].get("k6"), KERNEL), *k6_bytes_flops(rec["traffic"]["size"]["n"]))
