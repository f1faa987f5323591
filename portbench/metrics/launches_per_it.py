"""Kernel-launch runtime calls per CG iteration over the profiled requests
(torch.profiler's cudaLaunchKernel and kin)."""


def read(rec):
    p = rec["profile"]
    if not p or not p.get("its"):
        return None
    return p["launches"] / p["its"]
