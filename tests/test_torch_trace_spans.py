"""The port's inner spans and counters (utils/timing.py's trace table): the
table's arithmetic on a fake clock, the replay bookkeeping of the shared
CUDA-graph helper (la/cycle_graph.py), and the spans that the GMG V-cycle,
the class stack's conversions, the BELL conversion, CSRMatrix.to_scipy, the
AMG set-up and the AMG V-cycle open, counted on small problems on the
CPU."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import dolfinx_mpc_tpu_torch as pt
from dolfinx_mpc_tpu_torch.fem import forms as PF, mesh as PM
from dolfinx_mpc_tpu_torch.la.amg import smoothed_aggregation_amg
from dolfinx_mpc_tpu_torch.la import bell
from dolfinx_mpc_tpu_torch.la.bell import bell_arrays_from_scipy, bell_from_scipy
from dolfinx_mpc_tpu_torch.la.sparse import csr_from_scipy
from dolfinx_mpc_tpu_torch.utils import timing as tt

PHASES = ("pre", "down", "up", "post")


@pytest.fixture(autouse=True)
def fresh_tables():
    tt.reset_timings()
    yield
    tt.reset_timings()


def _laplacian(n, dim):
    """The (n^dim)-row finite-difference Laplacian, Dirichlet all round."""
    T = sp.diags([-np.ones(n - 1), 2.0 * np.ones(n), -np.ones(n - 1)], [-1, 0, 1])
    A, eye = T, sp.identity(n)
    for _ in range(dim - 1):
        A = sp.kron(A, eye) + sp.kron(sp.identity(A.shape[0]), T)
    return A.tocsr()


def test_trace_table_on_a_fake_clock(monkeypatch):
    """A span adds one call, its seconds to the total and raises the max;
    a counter adds its amounts the same way; ~MPC: spans stay in their own
    table; reset_timings clears both."""
    clock = iter([0.0, 0.5, 10.0, 12.0, 20.0, 20.25, 30.0, 31.0])
    monkeypatch.setattr(tt.time, "perf_counter", lambda: next(clock))
    with tt.span("gmg.coarse"):
        pass
    with tt.span("gmg.coarse"):
        pass
    with tt.timed("~MPC: Finalize MPC"):
        pass
    tt.count("bell.upload_bytes", 1000)
    tt.count("bell.upload_bytes", 24)
    tt.traced("bell.pack")(lambda: None)()
    assert tt.trace_timings() == {"gmg.coarse": (2, 2.5, 2.0), "bell.upload_bytes": (2, 1024, 1000),
                                  "bell.pack": (1, 1.0, 1.0)}
    assert tt.timings() == {"~MPC: Finalize MPC": (1, 0.25, 0.25)}
    tt.reset_timings()
    assert tt.trace_timings() == {} and tt.timings() == {}


def test_traced_keeps_the_function_and_closes_on_raise():
    """traced() returns the function's result under its own name, and the
    span closes when the body raises."""

    @tt.traced("amg.setup")
    def f(x, y=1):
        """doc"""
        if x is None:
            raise ValueError("x")
        return x + y

    assert f(2, y=3) == 5 and f.__name__ == "f" and f.__doc__ == "doc"
    with pytest.raises(ValueError):
        f(None)
    assert tt.trace_timings()["amg.setup"][0] == 2


def test_call_record_adds_calls_without_seconds(monkeypatch):
    """CallRecord keeps the calls that spans and counters made while it was
    open; after k adds each name's calls have grown by k times that, and
    no total or maximum has; add(-k) takes them back."""
    clock = iter(float(v) for v in range(100))
    monkeypatch.setattr(tt.time, "perf_counter", lambda: next(clock))
    with tt.span("gmg.vcycle"):
        pass
    rec = tt.CallRecord()
    with rec:
        with tt.span("gmg.L0.pre"):
            pass
        for _ in range(2):
            with tt.span("gmg.coarse"):
                pass
        tt.count("gmg.graph_capture", 1)
    assert rec.calls == {"gmg.L0.pre": 1, "gmg.coarse": 2, "gmg.graph_capture": 1}
    before = tt.trace_timings()
    k = 3
    for _ in range(k):
        rec.add()
    after = tt.trace_timings()
    assert set(after) == set(before)
    for name, (calls, total, most) in after.items():
        assert calls == before[name][0] + k * rec.calls.get(name, 0)
        assert (total, most) == before[name][1:]
    rec.add(-k)
    assert tt.trace_timings() == before


def test_launch_record_adds_launch_counts():
    """LaunchRecord keeps what count_launch (and K7's count by grid) added
    to the wrappers' counters while it was open, and adds it again k times
    over; a negative k takes it back."""
    from dolfinx_mpc_tpu_torch._launch import LaunchRecord, count_launch

    def k2():
        pass

    def k7():
        pass

    k2.launches, k2.launches_by_dtype = 5, {"float32": 5}
    k7.launches, k7.launches_by_dtype, k7.launches_by_grid = 0, {}, {(9, 9, 9): 2}
    rec = LaunchRecord((k2, k7))
    with rec:
        count_launch(k2, torch.float32)
        count_launch(k2, torch.complex64)
        count_launch(k7, torch.float64)
        k7.launches_by_grid[(5, 5, 5)] = 1
    rec.add(3)
    assert (k2.launches, k2.launches_by_dtype) == (5 + 2 * 4, {"float32": 5 + 4, "complex64": 4})
    assert (k7.launches, k7.launches_by_dtype, k7.launches_by_grid) == (4, {"float64": 4},
                                                                         {(9, 9, 9): 2, (5, 5, 5): 4})
    rec.add(-4)
    assert (k2.launches, k2.launches_by_dtype["float32"], k7.launches, k7.launches_by_grid[(9, 9, 9)]) == (5, 5, 0, 2)


def _lattice_level(n):
    V = pt.functionspace(PM.create_unit_cube(n, n, n), ("Lagrange", 1))
    bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = pt.MultiPointConstraint(V, np.float64, device="cpu")
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: PF.inner(PF.grad(u), PF.grad(v)), quad_degree=1)
    return pt.assemble_matrix_lattice(a, mpc, bcs=[bc], side_format="fold", device="cpu")


@pytest.fixture(scope="module")
def hierarchy():
    return pt.build_gmg_hierarchy(_lattice_level, 8, 3, min_n=2)


@pytest.mark.parametrize("coarse", ["dense", "chebyshev", "cg"])
def test_vcycle_spans_under_cg(hierarchy, coarse):
    """GMG-CG on a 3-level P1 lattice: one gmg.vcycle per application (CG
    applies M its + 1 times), gmg.coarse and every level phase once per
    V-cycle, and the phases, each holding only its own work, sum to at
    most the V-cycles' time."""
    ops, masks = hierarchy
    M = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev", coarse=coarse, cheb_degree=8)
    tt.reset_timings()
    b = torch.as_tensor(np.random.default_rng(1).standard_normal(ops[0].shape[0]))
    _, its, _ = pt.cg(ops[0].matvec, b, M=M, rtol=1e-8, max_it=500)
    t = tt.trace_timings()
    names = {f"gmg.L{lvl}.{p}" for lvl in range(len(ops) - 1) for p in PHASES}
    assert set(t) == names | {"gmg.vcycle", "gmg.coarse"} and 0 < its < 500
    calls = t["gmg.vcycle"][0]
    assert calls == its + 1
    assert all(t[k][0] == calls for k in names | {"gmg.coarse"})
    assert sum(t[k][1] for k in names | {"gmg.coarse"}) <= t["gmg.vcycle"][1]
    assert tt.timings() == {}


@pytest.mark.parametrize("coarse", ["dense", "chebyshev", "cg", "blocked_io"])
def test_cpu_vcycle_is_the_eager_cycle(hierarchy, p2_hierarchy, coarse):
    """A CPU input takes the eager cycle, bit for bit, in every coarse mode
    and with blocked I/O: no graph, no gmg.graph_* counter."""
    if coarse == "blocked_io":
        ops, masks = p2_hierarchy
        M = pt.LatticeGMG(ops, free_masks=masks, blocked_io=True, smoother="chebyshev")
    else:
        ops, masks = hierarchy
        M = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev", coarse=coarse, cheb_degree=8)
    r = torch.as_tensor(np.random.default_rng(4).standard_normal(ops[0].shape[0]))
    if M.blocked_io:
        r = ops[0].to_blocked(r)
    tt.reset_timings()
    y = M(r)
    assert torch.equal(y, M._vcycle(0, r)) and torch.equal(M(r), y)
    t = tt.trace_timings()
    assert t["gmg.vcycle"][0] == 2 and not [k for k in t if k.startswith("gmg.graph")]
    assert M._graphs == {}


def test_memory_report_walks_a_captured_cycle(hierarchy):
    """The sharded path's memory_report walks a LatticeGMG's attributes
    (parallel/lattice_spmd.py:_tensor_bytes): a captured cycle in _graphs,
    its records among them, adds its static input and output and nothing
    else.  (A CPU hierarchy captures nothing, so the entry is made here as
    _capture makes it on the card.)"""
    from dolfinx_mpc_tpu_torch._launch import LaunchRecord
    from dolfinx_mpc_tpu_torch.la.gmg import _Graph
    from dolfinx_mpc_tpu_torch.ops import lattice_kernels as LK
    from dolfinx_mpc_tpu_torch.parallel.lattice_spmd import _tensor_bytes

    ops, masks = hierarchy
    M = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev")
    before = _tensor_bytes(M)
    x = torch.zeros(ops[0].shape[0], dtype=ops[0].dtype)
    spans, launches = tt.CallRecord(), LaunchRecord((LK.dia_matvec, LK.dia_matvec_bs, LK.blocked_matvec))
    with spans, launches:
        y = M._vcycle(0, x)
    M._graphs = {(tuple(x.shape), x.dtype, x.device): _Graph(object(), x, y, spans, launches)}
    assert _tensor_bytes(M) == before + x.nbytes + y.nbytes


class _DoublingGraph:
    """Stands in for a captured torch.cuda.CUDAGraph on the CPU: replay()
    writes 2 x into the static output and opens no span."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def replay(self):
        torch.mul(self.x, 2.0, out=self.y)


def test_cycle_graph_replay_re_adds_one_cycle(hierarchy):
    """la/cycle_graph.replay on a table that holds the input's layout: the
    cycle itself is not run; each replay copies the input in, returns a copy
    of the static output, counts <prefix>.graph_replay and re-adds the span
    calls and wrapper launches of the one eager cycle its records saw; a
    negative add takes them back."""
    from dolfinx_mpc_tpu_torch._launch import LaunchRecord, count_launch
    from dolfinx_mpc_tpu_torch.la.cycle_graph import CycleGraph, replay

    ops, masks = hierarchy
    M = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev")

    def k8():
        pass

    k8.launches, k8.launches_by_dtype = 0, {}

    def cycle(v):
        count_launch(k8, v.dtype)
        return M._vcycle(0, v)

    x = torch.zeros(ops[0].shape[0], dtype=ops[0].dtype)
    spans, launches = tt.CallRecord(), LaunchRecord((k8,))
    with spans, launches:
        y = cycle(x)
    one = {name: v[0] for name, v in tt.trace_timings().items()}
    assert one == spans.calls and one["gmg.coarse"] == 1 and k8.launches == 1
    spans.add(-1)
    launches.add(-1)
    assert all(v[0] == 0 for v in tt.trace_timings().values()) and k8.launches == 0
    graphs = {(tuple(x.shape), x.dtype, x.device): CycleGraph(_DoublingGraph(x, y), x, y, spans, launches)}

    def not_run(v):
        raise AssertionError("a replay ran the eager cycle")

    rs = [torch.as_tensor(np.random.default_rng(s).standard_normal(x.shape[0])) for s in range(3)]
    outs = [replay(graphs, not_run, r, "amg", (k8,)) for r in rs]
    for r, out in zip(rs, outs):
        assert torch.equal(out, 2.0 * r) and out.data_ptr() != y.data_ptr()
    k = len(rs)
    t = {name: v[0] for name, v in tt.trace_timings().items()}
    assert t.pop("amg.graph_replay") == k and t == {name: k * n for name, n in one.items()}
    assert (k8.launches, k8.launches_by_dtype) == (k, {"float64": k})
    spans.add(-k)
    launches.add(-k)
    assert all(v[0] == 0 for n, v in tt.trace_timings().items() if n != "amg.graph_replay")
    assert (k8.launches, k8.launches_by_dtype) == (0, {"float64": 0})


def test_graph_tables_are_per_instance(hierarchy):
    """A LatticeGMG, its tail and an AMG each keep their own graph table: an
    entry in one is in no other."""
    ops, masks = hierarchy
    M = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev")
    tail = M.tail(1)
    amg = smoothed_aggregation_amg(_laplacian(8, 3), coarse_size=100, dtype=np.float64, device="cpu")
    tables = [M._graphs, tail._graphs, amg._graphs]
    assert tables == [{}, {}, {}] and len({id(t) for t in tables}) == 3
    M._graphs["layout"] = None
    assert tail._graphs == {} and amg._graphs == {} and M.tail(1)._graphs == {}


def _p2_level(lv):
    deg, n = lv
    V = pt.functionspace(PM.create_unit_cube(n, n, n), ("Lagrange", deg))
    bc = pt.dirichletbc(0.0, pt.locate_dofs_geometrical(
        V, lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], 1.0)), V)
    mpc = pt.MultiPointConstraint(V, np.float64, device="cpu")
    mpc.create_periodic_constraint_geometrical(
        V, lambda x: np.isclose(x[0], 1.0), lambda x: np.stack([1.0 - x[0], x[1], x[2]]), [bc])
    mpc.finalize()
    a = pt.BilinearForm(V, lambda u, v, c: PF.inner(PF.grad(u), PF.grad(v)), quad_degree=deg)
    return pt.assemble_matrix_lattice(a, mpc, bcs=[bc], side_format="fold", device="cpu")


@pytest.fixture(scope="module")
def p2_hierarchy():
    """bench.py's p-coarsened levels at P2 n = 4: P2 4, P1 8, P1 4."""
    return pt.build_gmg_hierarchy(_p2_level, 4, 0, levels=[(2, 4), (1, 8), (1, 4)])


@pytest.mark.parametrize("name", ["to_blocked", "from_blocked"])
def test_class_stack_conversion_spans(p2_hierarchy, name):
    """lattice.to_blocked and lattice.from_blocked: one call per
    conversion of the operator's public name, one of each per V-cycle with
    blocked I/O (at the level-0/1 transfer), and one around every fine
    product of a cycle that takes flat vectors over the same blocked level."""
    ops, masks = p2_hierarchy
    A = ops[0]
    r = torch.as_tensor(np.random.default_rng(2).standard_normal(A.shape[0]))
    span = f"lattice.{name}"
    tt.reset_timings()
    rb = A.to_blocked(r)
    assert torch.equal(A.from_blocked(rb), r)
    assert tt.trace_timings()[span][0] == 1
    M = pt.LatticeGMG(ops, free_masks=masks, blocked_io=True, smoother="chebyshev")
    tt.reset_timings()
    M(rb)
    M(rb)
    t = tt.trace_timings()
    assert t["gmg.vcycle"][0] == 2 and t[span][0] == 2
    flat = pt.LatticeGMG(ops, free_masks=masks, smoother="chebyshev")
    tt.reset_timings()
    flat(r)
    t = tt.trace_timings()
    # Chebyshev 2 + 2 on the fine level: 4 products before and after, one residual
    assert t["gmg.vcycle"][0] == 1 and t[span][0] == 9


def test_bell_conversion_spans_and_bytes():
    """bell_from_scipy opens bell.pack and bell.upload once each, and
    bell.upload_bytes holds the bytes of the host arrays sent (data, int32
    tile columns, diagonal, remainder values, int64 remainder indices); the
    first conversion of a pattern counts bell.plan_miss, a second one with
    other values bell.plan_hit, and sends the float32 values alone;
    CSRMatrix.to_scipy opens csr.to_scipy once."""
    A = _laplacian(12, 2) + sp.random(144, 144, density=0.02, random_state=3)
    A = A.tocsr()
    arrays = bell_arrays_from_scipy(A, mt_cap=1)
    data, cols, diag, rem_data, rem_rows, rem_cols, _ = arrays
    assert rem_data.shape[0] > 0  # the remainder is in the count too
    sent = data.nbytes + 4 * cols.size + diag.nbytes + rem_data.nbytes + 8 * (rem_rows.size + rem_cols.size)
    bell._plans.clear()
    tt.reset_timings()
    B = bell_from_scipy(A, mt_cap=1, device="cpu")
    t = tt.trace_timings()
    assert {k: v[0] for k, v in t.items()} == {"bell.pack": 1, "bell.upload": 1, "bell.upload_bytes": 1,
                                               "bell.plan_miss": 1}
    assert t["bell.upload_bytes"][1] == sent
    assert abs(B.to_scipy() - A).max() < 1e-6
    A2 = A.copy()
    A2.data = 1.5 * A2.data
    B2 = bell_from_scipy(A2, mt_cap=1, device="cpu")
    t = tt.trace_timings()
    assert {k: v[0] for k, v in t.items()} == {"bell.pack": 2, "bell.upload": 2, "bell.upload_bytes": 2,
                                               "bell.plan_miss": 1, "bell.plan_hit": 1}
    assert t["bell.upload_bytes"][1] == sent + 4 * A2.nnz
    assert abs(B2.to_scipy() - A2).max() < 1e-6
    C = csr_from_scipy(A, device="cpu")
    tt.reset_timings()
    assert abs(C.to_scipy() - A).max() == 0
    assert {k: v[0] for k, v in tt.trace_timings().items()} == {"csr.to_scipy": 1}


def test_amg_setup_spans_per_level():
    """smoothed_aggregation_amg opens amg.setup, amg.to_device and
    amg.coarse_inverse once, and amg.aggregate, amg.prolongator and
    amg.galerkin once per coarsening level."""
    A = _laplacian(14, 3)
    M = smoothed_aggregation_amg(A, coarse_size=100, dtype=np.float64, device="cpu")
    levels = len(M.Ps)
    assert levels >= 2
    t = {k: v[0] for k, v in tt.trace_timings().items()}
    assert t == {"amg.setup": 1, "amg.aggregate": levels, "amg.prolongator": levels, "amg.galerkin": levels,
                 "amg.to_device": 1, "amg.coarse_inverse": 1}
    tot = tt.trace_timings()
    inner = ("amg.aggregate", "amg.prolongator", "amg.galerkin", "amg.to_device", "amg.coarse_inverse")
    assert sum(tot[k][1] for k in inner) <= tot["amg.setup"][1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_amg_cycle_is_the_eager_cycle(dtype):
    """On the CPU AMG.__call__ is _vcycle(0, r) bit for bit: each call opens
    amg.vcycle once and nothing is captured or replayed."""
    M = smoothed_aggregation_amg(_laplacian(14, 3), coarse_size=100, dtype=dtype, device="cpu")
    assert len(M.Ps) >= 2
    r = torch.as_tensor(np.random.default_rng(5).standard_normal(M.ops[0].shape[0]).astype(dtype))
    tt.reset_timings()
    y = M(r)
    assert torch.equal(y, M._vcycle(0, r)) and torch.equal(M(r), y)
    assert {k: v[0] for k, v in tt.trace_timings().items()} == {"amg.vcycle": 2}
    assert M._graphs == {}
