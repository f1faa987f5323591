"""allreduce: a toy configuration of the benchmark's tests, which drives
the harness's ranks (portbench/core.py, Ranks) and no part of the port.

Every rank builds this Problem on its own device inside the default
process group.  A request draws one float32 vector per rank from the
run's seed, the request's index and the rank (portbench.inputs.probe_vector)
and sums them over the ranks with one all-reduce.  The traffic key
"raise_on_rank" makes that rank raise in its first request (a test of a
failing rank).  Each rank writes its process id to
build/portbench/toy_pids/<rank> under the checkout, so a test can see that
no rank outlives a run."""

import os
from pathlib import Path

import torch
import torch.distributed as dist

from portbench.inputs import probe_vector

CHECKOUT = Path(__file__).resolve().parents[2]


class Problem:
    def __init__(self, cfg, traffic, seed, device, tracer):
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        if self.world != cfg["ranks"]:
            raise ValueError(f"allreduce states {cfg['ranks']} ranks; the process group has {self.world}")
        self.traffic, self.seed, self.device, self.tr = traffic, seed, device, tracer
        self.n = traffic["size"]["n"]
        self.dtype = getattr(torch, cfg["dtype"])
        pids = CHECKOUT / "build" / "portbench" / "toy_pids"
        pids.mkdir(parents=True, exist_ok=True)
        (pids / str(self.rank)).write_text(str(os.getpid()))
        with tracer.setup_span("barrier"):
            dist.barrier()

    def request(self, k):
        """One all-reduce; ends in a synchronize.  Returns its outputs."""
        if self.traffic.get("raise_on_rank") == self.rank:
            raise RuntimeError(f"rank {self.rank} raises in request {k}, as its traffic asks")
        v = probe_vector(self.seed, k * self.world + self.rank, self.n, self.device, self.dtype)
        with self.tr.span("request"):
            with self.tr.span("all_reduce"):
                dist.all_reduce(v)
            if self.device.type == "cuda":
                torch.cuda.synchronize()
        return {"its": 1, "converged": True, "sum": v}

    def probes(self):
        return {}

    def finish(self, kept):
        """Collective: every rank calls it with the same requests kept."""
        dist.barrier()
        return [{"k": k, "sum": o["sum"]} for k, o in kept]

    def describe(self):
        return {"ranks": self.world, "n": self.n}
