"""The port's timing registry (utils/timing.py) against the JAX package's:
the same names and registry semantics, the same list_timings table, the
five "~MPC:" spans of a LinearProblem solve, and on a card an NVTX range
per span without a device synchronisation (checked here with the CUDA
calls replaced by recorders)."""

import io

import numpy as np
import pytest
import torch

import dolfinx_mpc_tpu as jx
import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu.fem import forms as jf, mesh as jm
from dolfinx_mpc_tpu.utils import timing as jt
from dolfinx_mpc_tpu_torch.fem import forms as pf, mesh as pm
from dolfinx_mpc_tpu_torch.utils import timing as tt

SPANS = ["~MPC: Assemble matrix", "~MPC: Assemble vector", "~MPC: Backsubstitution", "~MPC: Finalize MPC",
         "~MPC: Solve linear problem"]


@pytest.fixture(autouse=True)
def fresh_registries():
    tt.reset_timings()
    jt.reset_timings()
    yield
    tt.reset_timings()
    jt.reset_timings()


def test_exports_match_the_jax_package():
    assert pt.Timer is tt.Timer and pt.list_timings is tt.list_timings and pt.timed is tt.timed
    assert tt.__all__ == jt.__all__
    assert jx.Timer is jt.Timer and jx.list_timings is jt.list_timings


def test_registry_counts_totals_and_max(monkeypatch):
    """Each stop adds one call, its elapsed time to the total and raises the
    max; start() returns the timer and stop() the elapsed time (a fake
    clock makes every number exact)."""
    clock = iter([0.0, 0.5, 10.0, 12.0, 20.0, 20.25])
    monkeypatch.setattr(tt.time, "perf_counter", lambda: next(clock))
    t = tt.Timer("a")
    assert t.start() is t and t.stop() == 0.5
    assert t.start() is t and t.stop() == 2.0
    with tt.Timer("b"):
        pass
    assert tt.timings() == {"a": (2, 2.5, 2.0), "b": (1, 0.25, 0.25)}
    tt.reset_timings()
    assert tt.timings() == {}


def test_timed_nesting():
    """timed spans nest: the inner span's time lies inside the outer's,
    each name counts its own calls, and a span closes when its body
    raises."""
    with tt.timed("outer") as outer:
        for _ in range(3):
            with tt.timed("inner"):
                sum(range(1000))
        assert outer.elapsed() >= 0.0
    with pytest.raises(ZeroDivisionError):
        with tt.timed("inner"):
            1 / 0
    t = tt.timings()
    assert t["outer"][0] == 1 and t["inner"][0] == 4
    assert t["inner"][1] - t["inner"][2] <= t["outer"][1]
    assert 0.0 <= t["inner"][2] <= t["inner"][1]


def test_list_timings_format_matches_jax():
    """On the same registry both packages print the same table."""
    rows = {"~MPC: Assemble matrix": [3, 0.125, 0.0625], "x": [1, 2.5, 2.5], "~MPC: Finalize MPC": [2, 0.0, 0.0]}
    outs = []
    for mod in (tt, jt):
        for k, v in rows.items():
            mod._registry[k] = list(v)
        buf = io.StringIO()
        mod.list_timings(file=buf)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 4
    tt.reset_timings()
    jt.reset_timings()
    bufs = [io.StringIO(), io.StringIO()]
    tt.list_timings(None, bufs[0])
    jt.list_timings(None, bufs[1])
    assert bufs[0].getvalue() == bufs[1].getvalue()


def _problem(pkg):
    """A periodic Poisson problem on a mesh without lattice information (so
    that LinearProblem assembles through assemble_matrix in both
    packages)."""
    mod, F, M = {"jx": (jx, jf, jm), "pt": (pt, pf, pm)}[pkg]
    sq = M.create_unit_square(4, 4)
    V = mod.functionspace(M.Mesh(sq.points.copy(), sq.cells.copy(), sq.cell_type), ("Lagrange", 1))
    bc = mod.dirichletbc(0.0, mod.locate_dofs_geometrical(V, lambda x: np.isclose(x[1], 0.0)), V)
    mpc = mod.MultiPointConstraint(V, **({"device": "cpu"} if pkg == "pt" else {}))
    mpc.create_periodic_constraint_geometrical(V, lambda x: np.isclose(x[0], 1.0),
                                               lambda x: np.stack([1.0 - x[0], x[1]]), [bc])
    mpc.finalize()
    a = mod.BilinearForm(V, lambda u, v, c: F.inner(F.grad(u), F.grad(v)))
    L = mod.LinearForm(V, lambda v, c: 1.0 * v.value)
    return mod.LinearProblem(a, L, mpc, bcs=[bc], petsc_options={"ksp_rtol": 1e-10})


def test_linear_problem_opens_the_five_spans():
    """Building the constraint and solving a LinearProblem on the CPU opens
    the JAX package's five spans, once each, in both packages."""
    _problem("pt").solve()
    _problem("jx").solve()
    tp, tj = tt.timings(), jt.timings()
    assert sorted(tp) == SPANS and sorted(tj) == SPANS
    assert {k: v[0] for k, v in tp.items()} == {k: v[0] for k, v in tj.items()} == dict.fromkeys(SPANS, 1)
    buf = io.StringIO()
    pt.list_timings(file=buf)
    assert all(name in buf.getvalue() for name in SPANS)


def test_spans_push_nvtx_ranges_without_a_sync(monkeypatch):
    """Where CUDA is available a span pushes an NVTX range named after it
    and pops it at its end, nested spans in order, and never synchronises
    the device (the CUDA calls are replaced by recorders here)."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: calls.append(("pop",)))

    def no_sync(*a, **k):
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with tt.timed("~MPC: Solve linear problem"):
        with tt.Timer("~MPC: Backsubstitution"):
            pass
    assert calls == [("push", "~MPC: Solve linear problem"), ("push", "~MPC: Backsubstitution"), ("pop",), ("pop",)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls.clear()
    with tt.timed("x"):
        pass
    assert calls == [] and tt.timings()["x"][0] == 1
