"""The exchange between chips left out: this process's all-reduce takes
part in the collective on a copy and leaves its own tensor as it was, so
the peers do not hang and its answer holds its own share alone.

Proven on the toy `allreduce` alone, whose one exchange is one
all-reduce.  The patch reaches rank 0's process only (spawned ranks do
not inherit it), and it leaves point-to-point exchanges (isend, irecv,
batch_isend_irecv) as they are.  On a path with halo exchanges and an
iterative solve, rank 0 could then take another number of iterations
than its peers and leave them waiting: the fault that drops such a
path's exchange, on every rank, is for that path's cell to choose."""


def apply(monkeypatch):
    import torch.distributed as dist

    orig = dist.all_reduce

    def dropped(tensor, *args, **kw):
        return orig(tensor.clone(), *args, **kw)

    monkeypatch.setattr(dist, "all_reduce", dropped)
