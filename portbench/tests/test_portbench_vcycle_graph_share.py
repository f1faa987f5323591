"""The reader of vcycle_graph_share: None without the counter
gmg.graph_replay or without V-cycles, replays / V-cycles in % with them,
and None in a traced run of the tiny .solve cell on the CPU, where the
V-cycle runs eagerly."""

import pytest

from test_portbench_layout import BENCH
from test_portbench_program_spans import _traced_small


@pytest.mark.parametrize("table,share", [
    ({}, None),
    ({"gmg.vcycle": (16, 0.2, 0.05)}, None),
    ({"gmg.vcycle": (0, 0.0, 0.0), "gmg.graph_replay": (0, 0, 0)}, None),
    ({"gmg.vcycle": (16, 0.2, 0.05), "gmg.graph_replay": (16, 16, 1), "gmg.graph_capture": (1, 1, 1)}, 100.0),
    ({"gmg.vcycle": (20, 0.2, 0.05), "gmg.graph_replay": (15, 15, 1)}, 75.0),
])
def test_vcycle_graph_share_reader(monkeypatch, table, share):
    from portbench.core import load_module
    from portbench.metrics import _program_spans

    monkeypatch.setattr(_program_spans, "table", lambda: table)
    assert load_module("metrics", "vcycle_graph_share").read({}) == share


def test_vcycle_graph_share_is_silent_on_the_cpu():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "vcycle_graph_share")
    assert m["workloads"] == ["p1_n216.solve", "p2_n108.solve"] and m["moves"] == "solve_ms"
    res = _traced_small("p1_n216.solve")
    assert "vcycle_graph_share" not in res["metrics"] and "cg_its" in res["metrics"]
