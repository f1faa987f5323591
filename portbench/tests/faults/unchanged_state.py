"""A step that returns its state unchanged: CG hands back its starting
iterate, so x stays as it was."""


def apply(monkeypatch):
    import torch

    import dolfinx_mpc_tpu_torch as dmt

    monkeypatch.setattr(dmt, "cg", lambda A, b, M=None, **kw: (torch.zeros_like(b), 1, float(b.norm())))
