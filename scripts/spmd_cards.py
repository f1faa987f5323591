#!/usr/bin/env python3
"""chip_smoke.py's phase 13 (the distributed paths) on its own, or the
distributed cases over NCCL with one rank per card.

    python3 scripts/spmd_cards.py            # phase 13 alone, one card
    python3 scripts/spmd_cards.py --nccl     # every card, one NCCL rank each

Run from the repository root.  Without arguments it builds the kernels and
calls chip_smoke.slice13_phases (the dry run on 8 gloo ranks sharing the
card and on 1 NCCL rank, the P1 n=64 / n=102 / bs=3 / general sharded
solves on 4 gloo ranks, the SoA element kernel).  With --nccl it runs, on
as many NCCL ranks as there are cards, dryrun_multichip's six scenarios
(its counts and residuals printed as the JAX package prints them) and
phase 13's P1 n=64 two-level GMG, general-path and bs=3 n=16 cases, each
against the single-device solve (gate 1e-7), with chip_smoke's per-rank
lines (ms/it, the exchange's host ms/it, memory, launches)."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def nccl_all_cards():
    import numpy as np
    import torch

    from dolfinx_mpc_tpu_torch.parallel import run_ranks
    from dolfinx_mpc_tpu_torch.parallel.dryrun import dryrun_multichip

    n = torch.cuda.device_count()
    print(cs.card_line(), f"x {n}", flush=True)
    t0 = time.time()
    outs = dryrun_multichip(n, backend="nccl", device="cuda")
    print(f"dry run on {n} NCCL ranks: {time.time() - t0:.1f} s, launches per rank {[o['launches'] for o in outs]}",
          flush=True)
    cases = (("gmg", cs.N_SPMD), ("general", cs.N_SPMD), ("vector", cs.N_SPMD_VECTOR))
    res = run_ranks(cs._spmd_rank, n, backend="nccl", device="cuda", args=(cases,))
    dev = torch.device("cuda")
    ref = {"gmg": cs.single_device_solution(cs.N_SPMD, dev)[0],
           "vector": cs.single_device_solution(cs.N_SPMD_VECTOR, dev, vector=True)[0]}
    ref["general"] = ref["gmg"]
    for i, (case, _) in enumerate(cases):
        rs = [r[i] for r in res]
        err = float(np.abs(rs[0]["u"] - ref[case]).max())
        print(f"{case} on {n} NCCL ranks: CG {[r['its'] for r in rs]} its, max|u - u_single| {err:.3e} "
              f"(gate {cs.SPMD_GATE:g})", flush=True)
        for r in rs:
            print("    " + cs._rank_line(r), flush=True)
        if not err <= cs.SPMD_GATE:
            cs.fail(f"{case}: the {n}-rank solution differs from the single-device one by {err:.3e}")
        bad = [r["vs_plain"] for r in rs if not r["vs_plain"]["rel"] <= cs.SPMD_KERNEL_GATE]
        if bad:
            cs.fail(f"{case}: a kernel differs from its plain version on a rank's operator: {bad}")


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from dolfinx_mpc_tpu_torch._build import load_kernels

    load_kernels()
    if "--nccl" in sys.argv[1:]:
        nccl_all_cards()
    else:
        print(cs.card_line(), flush=True)
        cs.slice13_phases(torch.device("cuda"), None)


if __name__ == "__main__":
    main()
