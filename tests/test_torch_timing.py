"""The port's timing registry (utils/timing.py) against the JAX package's:
the same names and registry semantics, the same list_timings table, the
five "~MPC:" spans of a LinearProblem solve, and a profiler range per span
while a profiler records, none and no device synchronisation while none
does."""

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


def test_spans_open_profiler_ranges_only_while_profiling(monkeypatch):
    """Under torch.profiler a span, ~MPC: or inner, is a range of its name
    in the trace, nested as the calls nest, the operators it runs inside
    it; it is not a user annotation, which would add a copy on the device's
    timeline.  With the profiler off a span opens no range (the range
    openers and the CUDA calls are replaced by raising stand-ins here) and
    never synchronises."""
    from torch.profiler import ProfilerActivity, profile

    names = ["~MPC: Solve linear problem", "gmg.vcycle", "gmg.coarse"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tt.timed(names[0]):
            with tt.span(names[1]):
                with tt.span(names[2]):
                    torch.ones(8).sum()
    ev = {e.name: e for e in prof.events() if e.name in names}
    assert sorted(ev) == sorted(names)
    ranges = [ev[n].time_range for n in names]
    for outer, inner in zip(ranges, ranges[1:]):
        assert outer.start <= inner.start <= inner.end <= outer.end
    ops = [e.time_range for e in prof.events() if e.name == "aten::sum"]
    assert ops and ranges[2].start <= ops[0].start <= ops[0].end <= ranges[2].end
    assert not any(getattr(ev[n], "is_user_annotation", False) for n in names)
    assert tt.timings()[names[0]][0] == 1 and tt.trace_timings()[names[2]][0] == 1

    def forbidden(*a, **k):
        raise AssertionError("a span called into torch or CUDA with the profiler off")

    for mod, attr in ((torch.profiler, "record_function"), (torch.autograd.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast"), (torch.cuda, "synchronize"),
                      (torch.cuda, "is_available"), (torch.cuda.nvtx, "range_push"), (torch.cuda.nvtx, "range_pop")):
        monkeypatch.setattr(mod, attr, forbidden)
    with tt.timed("~MPC: Solve linear problem"):
        with tt.Timer("~MPC: Backsubstitution"):
            with tt.span("gmg.coarse"):
                pass
    assert tt.timings()["~MPC: Backsubstitution"][0] == 1 and tt.trace_timings()["gmg.coarse"][0] == 2
