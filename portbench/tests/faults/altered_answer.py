"""An answer altered where it is produced: backsubstitution alters one
value of the solution it returns."""


def apply(monkeypatch):
    from dolfinx_mpc_tpu_torch.multipointconstraint import FinalizedMPC

    orig = FinalizedMPC.backsubstitution

    def altered(self, u):
        out = orig(self, u)
        i = int(out.abs().argmax())
        out[i] = out[i] * 1.01
        return out

    monkeypatch.setattr(FinalizedMPC, "backsubstitution", altered)
