"""An answer altered where it is produced, for a configuration whose
answer is an all-reduce: this process alters one value of each
all-reduce's result.  Proven on the toy `allreduce` alone; like
exchange_dropped, it reaches rank 0's process only."""


def apply(monkeypatch):
    import torch.distributed as dist

    orig = dist.all_reduce

    def altered(tensor, *args, **kw):
        work = orig(tensor, *args, **kw)
        flat = tensor.view(-1)
        i = int(flat.abs().argmax())
        flat[i] = flat[i] * 1.01
        return work

    monkeypatch.setattr(dist, "all_reduce", altered)
