"""The readers of the port's own spans and counters (coarse_share,
to_scipy_ms, bell_pack_ms, bell_upload_mb): a traced run of each cell at
its configuration's small size on the CPU, each in a process of its own as
the harness runs it, reports them where their `workloads` list them and
only there; and on the card the coarse solve's kernels are launched inside
gmg.coarse's range of the profiler's trace."""

import json

import pytest

from conftest import ROOT
from test_portbench_layout import BENCH, _python

NEW = ("coarse_share", "to_scipy_ms", "bell_pack_ms", "bell_upload_mb")


def _traced_small(name):
    out = _python(f"""
        import dataclasses, json, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from portbench.core import load_cell, run
        cell = load_cell({name!r})
        cell = dataclasses.replace(cell, traffic={{**cell.traffic, "size": cell.cfg["small"]}})
        code, res = run(cell, 2 ** 31 + 5, 0.2, 1, time.time(), device="cpu", log=lambda s: None)
        assert code == 0 and res["correct"], res
        print(json.dumps(res))
        """, ROOT)
    return json.loads(out.splitlines()[-1])


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_program_span_metrics_where_listed(name):
    listed = {m["name"] for m in BENCH["per_layer"] if m["name"] in NEW and name in m["workloads"]}
    res = _traced_small(name)
    got = set(res["metrics"]) & set(NEW)
    assert got == listed, (got, listed)
    m = {k: res["metrics"][k]["value"] for k in got}
    if "coarse_share" in m:
        assert 0.0 < m["coarse_share"] < 100.0
    if "bell_upload_mb" in m:
        assert m["bell_upload_mb"] > 0.0 and m["to_scipy_ms"] > 0.0 and m["bell_pack_ms"] > 0.0


def test_readers_find_nothing_without_the_table(monkeypatch):
    """A port without the trace table, or one whose spans had no calls:
    every reader returns None."""
    from portbench.core import load_module
    from portbench.metrics import _program_spans

    for table in ({}, {"gmg.coarse": (0, 0.0, 0.0), "gmg.vcycle": (0, 0.0, 0.0), "bell.upload": (0, 0.0, 0.0)}):
        monkeypatch.setattr(_program_spans, "table", lambda t=table: t)
        for name in NEW:
            assert load_module("metrics", name).read({}) is None, name


@pytest.mark.cuda
def test_coarse_kernels_launch_inside_the_coarse_span(card):
    """GMG on a small P1 lattice with a Chebyshev coarse solve on the card,
    under torch.profiler: the kernels launched inside gmg.coarse's range
    ran (each found on the device timeline by its correlation id), every
    K2 launch of the coarse level is among them, and no span of the port
    has a copy on the device's timeline."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import dolfinx_mpc_tpu_torch as dmt
    from portbench.configs.periodic_p1 import _lattice_form
    from portbench.trace import LAUNCH_CALLS

    cfg = json.loads((ROOT / "portbench" / "configs" / "periodic_p1.json").read_text())
    n = 32
    clf = _lattice_form(dmt, n, cfg, np.float32, card)[1]
    ops, masks = dmt.build_gmg_hierarchy(
        lambda m: clf if m == n else _lattice_form(dmt, m, cfg, np.float32, card)[1], n, 3, min_n=8)
    M = dmt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev", coarse="chebyshev", cheb_degree=10)
    b = torch.ones(ops[0].shape[0], dtype=torch.float32, device=card)
    M(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            M(b)
        torch.cuda.synchronize()
    events = prof.events()
    coarse = [e.time_range for e in events if e.name == "gmg.coarse" and e.device_type == DeviceType.CPU]
    assert len(coarse) == 3
    kernels = {e.id: e.name for e in events if e.device_type == DeviceType.CUDA}
    launched = [e for e in events if e.name in LAUNCH_CALLS and e.device_type == DeviceType.CPU]
    inside = [e for e in launched if any(r.start <= e.time_range.start <= r.end for r in coarse)]
    assert inside and all(e.id in kernels for e in inside)
    k2_inside = sum("dia_matvec_kernel" in kernels[e.id] for e in inside)
    assert k2_inside == 3 * 10  # one K2 launch per D^-1 A product of the degree-10 coarse solve
    ours = {e.name for e in events if e.device_type == DeviceType.CUDA} & {
        "gmg.vcycle", "gmg.coarse", *(f"gmg.L{lvl}.{p}" for lvl in range(2) for p in ("pre", "down", "up", "post"))}
    assert not ours
