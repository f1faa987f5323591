"""Run a function on every rank of a fresh torch.distributed process group.

``run_ranks(fn, world_size, backend=..., device=...)`` spawns one process
per rank (the ``spawn`` start method: the parent's CUDA state is never
forked), joins them through a ``file://`` store in a temporary directory
(no TCP port), calls ``fn(rank_info, *args)`` on each and returns the
ranks' return values in rank order.  A rank that raises fails the whole
call with ``torch.multiprocessing.ProcessRaisedException`` carrying its
traceback; the other ranks are terminated.  Where a rank's failure makes
others fail too (a collective whose peer has gone), the rank that raised
first is the one reported.

The transport is the caller's: ``backend="nccl"`` gives rank r the card
``cuda:r`` (one card per rank; NCCL refuses two ranks on one card),
``backend="gloo"`` runs every rank on ``device`` — the CPU, or one card
that the ranks share.  Each rank runs one intra-op thread.  ``fn`` and its
arguments are pickled: ``fn`` must be importable from a module the child
can import (it imports that module, and nothing else of the caller).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import traceback
from dataclasses import dataclass

import torch

__all__ = ["RankInfo", "run_ranks"]


@dataclass(frozen=True)
class RankInfo:
    rank: int
    world_size: int
    backend: str
    device: str  # the rank's device: "cpu", "cuda:r" (NCCL) or the shared card


def _rank_device(rank, backend, device):
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{rank}" if backend == "nccl" else f"cuda:{dev.index or 0}"
    return str(dev)


def _worker(rank, fn, world_size, backend, device, store, out_dir, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = _rank_device(rank, backend, device)
    if dev.startswith("cuda"):
        torch.cuda.set_device(torch.device(dev))
    kw = {"device_id": torch.device(dev)} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank, world_size=world_size, **kw)
    try:
        out = fn(RankInfo(rank, world_size, backend, dev), *args)
        dist.barrier()
    except BaseException:
        _claim_first_failure(out_dir, rank)
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _claim_first_failure(out_dir, rank):
    """Record this rank's traceback unless another rank's is there: the
    rank that raised first claims the file before its process group goes
    down, so a peer that fails only because of it comes later."""
    try:
        fd = os.open(os.path.join(out_dir, "first_failure"), os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return
    with os.fdopen(fd, "wb") as f:
        pickle.dump((rank, os.getpid(), traceback.format_exc()), f)


def run_ranks(fn, world_size, *, backend, device, args=()):
    """fn(RankInfo, *args) on world_size spawned ranks over `backend`
    ("gloo" or "nccl"); returns their results, rank 0 first."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"unknown transport {backend!r} (gloo or nccl)")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("the NCCL transport runs the ranks on cards")
        if world_size > torch.cuda.device_count():
            raise ValueError(f"NCCL: {world_size} ranks need {world_size} cards, "
                             f"{torch.cuda.device_count()} present (ranks sharing a card take gloo)")
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        from .._build import load_kernels

        load_kernels()  # built once here: the ranks only load the library
    with tempfile.TemporaryDirectory(prefix="dmt_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        try:
            mp.start_processes(_worker, args=(fn, world_size, backend, device, store, tmp, tuple(args)),
                               nprocs=world_size, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            first = os.path.join(tmp, "first_failure")
            if not os.path.exists(first):
                raise
            with open(first, "rb") as f:
                rank, pid, tb = pickle.load(f)
            raise mp.ProcessRaisedException(f"\n\n-- Process {rank} raised first:\n{tb}", rank, pid) from e
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
