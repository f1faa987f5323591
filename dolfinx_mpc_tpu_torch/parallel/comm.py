"""What ``shard_map`` gave the JAX package's distributed paths, on a
``torch.distributed`` process group.

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` with the
axes ("sx", "sy"); the port runs one process per rank, and ``RankGrid``
places the rank in a (Dx, Dy) grid of ranks (rank = ix * Dy + iy) and
offers the collectives the JAX code calls inside ``shard_map``:

- ``axis_index(axis)`` — ``jax.lax.axis_index``;
- ``psum`` / ``pmax`` over one axis or both — all-reduce over the axis'
  sub-group or the world;
- ``psum_scatter`` — ``jax.lax.psum_scatter(tiled=True)`` over the world:
  NCCL's reduce-scatter; over gloo an all-reduce and the rank's slice
  (gloo's reduce-scatter is not in every torch release);
- ``ppermute`` / ``exchange`` — ``jax.lax.ppermute`` along one axis, as one
  ``batch_isend_irecv`` of every (source, destination) pair; a rank that
  receives nothing gets zeros, as in JAX, and a pair of a rank with itself
  is a copy;
- ``all_gather`` — ``jax.lax.all_gather(tiled=True)`` over the world.

The transport is the process group's backend, chosen by the caller (see
parallel/launch.py:run_ranks): NCCL where every rank has a card of its own,
gloo for ranks on the CPU and for several ranks sharing one card.  gloo
moves CPU tensors only (but for all-reduce and broadcast), so with CUDA
tensors over gloo every collective copies the rank's buffer through pinned
host memory and back; the compute stays on the card.  Complex tensors
travel as their real views.  Every collective adds its host time to
``comm_s`` and one to ``calls``: the exchange's host cost per iteration.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["AXES", "RankGrid"]

AXES = ("sx", "sy")


class RankGrid:
    """This rank's place in a (Dx, Dy) grid over the initialized default
    process group, with the sub-groups of its two axes and its device.

    shape: (Dx, Dy) with Dx * Dy the world size; None is (world, 1), the
    x-slabs of a 1-D mesh.  device: where the rank's tensors live (the
    card unless the caller asks for the CPU).  Every rank must construct
    its RankGrid at the same point of its program: the sub-groups are made
    collectively."""

    def __init__(self, shape=None, device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError("RankGrid needs an initialized torch.distributed process group (parallel.run_ranks)")
        self.world = dist.get_world_size()
        self.rank = dist.get_rank()
        Dx, Dy = (self.world, 1) if shape is None else (int(shape[0]), int(shape[1]))
        if Dx * Dy != self.world:
            raise ValueError(f"rank grid {Dx} x {Dy} does not hold the {self.world} ranks")
        self.shape = (Dx, Dy)
        self.coords = divmod(self.rank, Dy)  # (ix, iy)
        self.backend = dist.get_backend()
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("the NCCL transport needs the ranks' tensors on their cards")
        self._stage = self.backend == "gloo" and self.device.type == "cuda"
        # per axis: None (one rank: nothing to reduce), the world, or the
        # sub-group holding this rank; every rank makes every group in one order
        self._groups = {}
        for axis, size in zip(AXES, self.shape):
            if size == 1:
                self._groups[axis] = None
            elif size == self.world:
                self._groups[axis] = dist.group.WORLD
            else:
                mine = None
                for other in range(self.world // size):
                    ranks = self._axis_ranks(axis, other)
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        mine = g
                self._groups[axis] = mine
        self.comm_s = 0.0
        self.calls = 0
        dist.barrier()

    # ------------------------------------------------------------------
    def _axis_ranks(self, axis, other):
        """Global ranks along `axis` at index `other` of the other axis."""
        Dx, Dy = self.shape
        if axis == "sx":
            return [ix * Dy + other for ix in range(Dx)]
        return [other * Dy + iy for iy in range(Dy)]

    def axis_index(self, axis):
        return self.coords[AXES.index(axis)]

    def axis_size(self, axis):
        return self.shape[AXES.index(axis)]

    def _rank_at(self, axis, idx):
        ix, iy = self.coords
        return (idx * self.shape[1] + iy) if axis == "sx" else (ix * self.shape[1] + idx)

    def _group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        big = [a for a in axes if self.axis_size(a) > 1]
        if not big:
            return None
        if len(big) == 2:
            return dist.group.WORLD
        return self._groups[big[0]]

    # ------------------------------------------------------------------
    def _out(self, t):
        """t as the transport moves it: a real view, on the host for gloo
        with CUDA tensors (pinned, so the copies may overlap)."""
        if self._stage:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            t = h
        return torch.view_as_real(t) if t.is_complex() else t

    def _recv_buf(self, like):
        """An empty transport buffer for a tensor like `like`."""
        t = (torch.empty(like.shape, dtype=like.dtype, pin_memory=True) if self._stage
             else torch.empty_like(like))
        return torch.view_as_real(t) if t.is_complex() else t

    def _back(self, t, like):
        """The transport's buffer t as a tensor like `like` (device, dtype);
        a staged buffer goes back to the card without a host wait (it is
        pinned, and the card's stream orders the copy before its use)."""
        if like.is_complex():
            t = torch.view_as_complex(t)
        return t.to(like.device, non_blocking=True) if self._stage else t

    def _tick(self, t0):
        self.comm_s += time.perf_counter() - t0
        self.calls += 1

    def _reduce(self, x, axes, op):
        g = self._group(axes)
        x = torch.as_tensor(x, device=self.device)
        if g is None:
            return x.clone()
        t0 = time.perf_counter()
        buf = self._out(x.contiguous().clone() if not self._stage else x.contiguous())
        dist.all_reduce(buf, op=op, group=g)
        out = self._back(buf, x)
        self._tick(t0)
        return out

    def psum(self, x, axes=AXES):
        """Sum of x over the ranks of `axes` ("sx", "sy" or both)."""
        return self._reduce(x, axes, dist.ReduceOp.SUM)

    def pmax(self, x, axes=AXES):
        """Max of a real x over the ranks of `axes`."""
        return self._reduce(x, axes, dist.ReduceOp.MAX)

    def psum_scatter(self, x):
        """Tiled reduce-scatter over the world along dim 0: the sum over
        ranks of x, rank r keeping rows [r*m, (r+1)*m), m = len(x) / world."""
        m = x.shape[0] // self.world
        if self.world == 1:
            return x.clone()
        t0 = time.perf_counter()
        x = x.contiguous()
        if self.backend == "nccl":
            out = torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            src = torch.view_as_real(x) if x.is_complex() else x
            dst = torch.view_as_real(out) if out.is_complex() else out
            dist.reduce_scatter_tensor(dst, src)
        else:
            buf = self._out(x if self._stage else x.clone())
            dist.all_reduce(buf)
            out = self._back(buf[self.rank * m:(self.rank + 1) * m].contiguous(), x)
        self._tick(t0)
        return out

    def all_gather(self, x):
        """Tiled all-gather over the world along dim 0."""
        if self.world == 1:
            return x.clone()
        t0 = time.perf_counter()
        x = x.contiguous()
        if self.backend == "nccl":
            out = torch.empty((self.world * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            src = torch.view_as_real(x) if x.is_complex() else x
            dst = torch.view_as_real(out) if out.is_complex() else out
            dist.all_gather_into_tensor(dst, src)
        else:
            src = self._out(x)
            parts = [self._recv_buf(x) for _ in range(self.world)]
            dist.all_gather(parts, src)
            out = self._back(torch.cat(parts), x)
        self._tick(t0)
        return out

    def exchange(self, items, axis):
        """Several ppermutes along `axis` in one batch_isend_irecv: items is
        a list of (x, perm), perm a list of (source, destination) axis
        indices; returns, per item, what this rank receives (zeros where no
        pair sends to it)."""
        me = self.axis_index(axis)
        ops, recvs, results = [], [], []
        t0 = time.perf_counter()
        for tag, (x, perm) in enumerate(items):
            x = x.contiguous()
            res = None
            for s, d in perm:
                if s == me and d == me:
                    res = x.clone()
                elif s == me:
                    ops.append(dist.P2POp(dist.isend, self._out(x), self._rank_at(axis, d), tag=tag))
                elif d == me:
                    buf = self._recv_buf(x)
                    ops.append(dist.P2POp(dist.irecv, buf, self._rank_at(axis, s), tag=tag))
                    recvs.append((len(results), buf, x))
            results.append(res if res is not None else torch.zeros_like(x))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            for i, buf, like in recvs:
                results[i] = self._back(buf, like)
            self._tick(t0)
        return results

    def ppermute(self, x, axis, perm):
        """jax.lax.ppermute of x along `axis` with the (source, destination)
        pairs `perm`."""
        return self.exchange([(x, perm)], axis)[0]

    def ring(self, axis, shift):
        """The ring permutation i -> i + shift along `axis`."""
        n = self.axis_size(axis)
        return [(i, (i + shift) % n) for i in range(n)]
