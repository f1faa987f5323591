"""periodic_p2's own pieces on the CPU: the reference's P2 stencil and the
couplings the rooflines count from it, the reference against the port's
blocked operator in float64, and the three new readers on records that
lack what they read."""

import numpy as np
import pytest
import torch

from portbench.core import load_module
from portbench.reference import periodic_p2 as ref_p2
from portbench.yardstick import bound_ms


def test_stencil_couplings_and_offsets():
    """230 (row class, column class, coarse offset) triples per box over 65
    fine offsets: every node pair of a Kuhn tet, what the port stores.  Of
    them 186 triples over 51 offsets are nonzero for the Laplacian; the
    other 44 hold exact zeros (pairs whose P2 gradients are orthogonal on
    every tet they share), which K4 writes and K6 reads all the same."""
    from portbench.yardstick_p2 import couplings, stencil

    triples, offsets = stencil()
    assert len(triples) == couplings() == 230 and len(offsets) == 65
    hexm = ref_p2.cube_matrix(4)
    summed = {}
    for a in range(27):
        for b in range(27):
            oa, ob = ref_p2.local_offset(a), ref_p2.local_offset(b)
            key = (tuple(oa % 2), tuple(ob - oa))
            summed[key] = summed.get(key, 0.0) + hexm[a, b]
    nonzero = {k for k, v in summed.items() if v != 0.0}
    assert len(nonzero) == 186 and len({d for _, d in nonzero}) == 51
    stored = {(c, tuple((np.array(c) + d) % 2), tuple((np.array(c) + d) // 2)) for c, d in nonzero}
    assert stored <= set(triples)


def test_cube_matrix_is_a_stiffness():
    """Symmetric, rows summing to zero (constants are in its kernel), and
    scaled by 1/n: the P2 Laplacian of a cube of side 1/n."""
    h4, h8 = ref_p2.cube_matrix(4), ref_p2.cube_matrix(8)
    assert np.array_equal(h4, h4.T) and np.abs(h4.sum(axis=1)).max() < 1e-14 * np.abs(h4).max()
    assert np.allclose(h8, h4 / 2, rtol=1e-14, atol=0)
    assert np.all(np.diag(h4) > 0)


def test_yardstick_bounds_at_n64():
    """PERF.md's bounds at n = 64 (8 x 65^3 stack, 230 x 65^3 couplings):
    K6 0.0807 ms, K4 0.0754 ms at 3.35 TB/s."""
    from portbench.yardstick_p2 import k4_bytes_flops, k6_bytes_flops

    assert k6_bytes_flops(64) == ((230 + 16) * 65 ** 3 * 4, 2 * 230 * 65 ** 3)
    assert k4_bytes_flops(64) == (230 * 65 ** 3 * 4, 0)
    assert round(bound_ms(*k6_bytes_flops(64)), 4) == 0.0807 and round(bound_ms(*k4_bytes_flops(64)), 4) == 0.0754


def _port_operator(n):
    import dolfinx_mpc_tpu_torch as dmt

    cfg = {"element": ["Lagrange", 2], "quad_degree": 2, "dirichlet": {"value": 0.0},
           "operator": {"side_format": "fold", "diagval": 1.0}}
    _, clf = load_module("configs", "periodic_p1")._lattice_form(dmt, n, cfg, np.dtype(np.float64),
                                                                  torch.device("cpu"))
    return clf.assemble()


def test_reference_matches_the_blocked_operator_f64():
    """K^T A K x of the reference against the port's blocked fold operator
    on the class stack, float64, n = 4: equal to 1e-12 on the reduced rows."""
    n = 4
    A = _port_operator(n)
    ref = ref_p2.PeriodicP2(n, "cpu")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((2 * n + 1,) * 3)) * ref.keep
    y = A.from_blocked(A.matvec_blocked(A.to_blocked(x.reshape(-1)))).reshape(x.shape)
    want = ref.rhs(x)
    assert float((y * ref.keep - want).abs().max()) < 1e-12 * float(want.abs().max())


def test_readers_return_none_without_their_probe_or_spans(monkeypatch):
    """k6_roofline and k4_roofline read None where the probe is missing or
    launched no such kernel, never 0; stack_per_vcycle reads None where the
    port keeps no such spans, and the conversions per V-cycle where it does."""
    from portbench.yardstick_p2 import k4_bytes_flops, k6_bytes_flops

    k6, k4 = load_module("metrics", "k6_roofline"), load_module("metrics", "k4_roofline")
    spans = load_module("metrics", "stack_per_vcycle")
    base = {"traffic": {"size": {"n": 108}}}
    for probes in ({}, {"k6": {}, "k4": {}}, {"k6": {"other": [1.0, 20]}, "k4": {"other": [1.0, 20]}}):
        assert k6.read({**base, "probes": probes}) is None and k4.read({**base, "probes": probes}) is None
    k6_ms, k4_ms = bound_ms(*k6_bytes_flops(108)), bound_ms(*k4_bytes_flops(108))
    probes = {"k6": {"void blocked_matvec_kernel<float, false>(...)": [20 * 2e-3 * k6_ms, 20]},
              "k4": {"void fold_assemble_kernel<float, true>(...)": [20 * 2e-3 * k4_ms, 20]}}
    assert k6.read({**base, "probes": probes}) == pytest.approx(50.0)
    assert k4.read({**base, "probes": probes}) == pytest.approx(50.0)
    for table, want in (({}, None), ({"gmg.vcycle": (10, 1.0, 0.1)}, None),
                        ({"lattice.to_blocked": (12, 0.1, 0.01)}, None),
                        ({"gmg.vcycle": (10, 1.0, 0.1), "lattice.to_blocked": (12, 0.1, 0.01),
                          "lattice.from_blocked": (11, 0.1, 0.01)}, 2.3)):
        monkeypatch.setattr(spans, "table", lambda t=table: t)
        got = spans.read({})
        assert got == want if want is None else got == pytest.approx(want)
