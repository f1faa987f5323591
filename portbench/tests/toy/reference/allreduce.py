"""The plain reference of the toy `allreduce`: the ranks' vectors drawn
again and added in float64."""

import torch

from portbench.inputs import probe_vector


def _vectors(cfg, traffic, seed, k, device, dtype):
    n, ranks = traffic["size"]["n"], cfg["ranks"]
    return [probe_vector(seed, k * ranks + r, n, device, dtype) for r in range(ranks)]


def judge(cfg, traffic, seed, kept, device, dtype=torch.float64):
    """sum_gap: |s - sum_r v_r|_inf / max_r |v_r|_inf, the worst over the
    kept requests, s the sum the timed path produced."""
    gap = 0.0
    for s in kept:
        vs = _vectors(cfg, traffic, seed, s["k"], device, dtype)
        ref = torch.stack(vs).sum(0)
        gap = max(gap, float((s["sum"].to(dtype) - ref).abs().max()) / max(float(v.abs().max()) for v in vs))
    return {"sum_gap": gap}, {"values": traffic["size"]["n"]}


def control(cfg, traffic, seed, ks, device):
    """The reference in the program's place in the precision below the
    configuration's (bfloat16 for float32): the vectors drawn and summed in it."""
    from portbench.reference.precision import lower

    dtype = lower(cfg["dtype"])
    return [{"k": k, "sum": torch.stack(_vectors(cfg, traffic, seed, k, device, dtype)).sum(0)} for k in ks]
