"""The reader of amg_graph_share: None without the counter amg.graph_replay
or without AMG V-cycles, replays / V-cycles in % with them, and None in a
traced run of the tiny .newton cell on the CPU, where the AMG V-cycle runs
eagerly."""

import pytest

from test_portbench_layout import BENCH
from test_portbench_program_spans import _traced_small


@pytest.mark.parametrize("table,share", [
    ({}, None),
    ({"amg.vcycle": (11, 0.2, 0.05)}, None),
    ({"amg.vcycle": (0, 0.0, 0.0), "amg.graph_replay": (0, 0, 0)}, None),
    ({"gmg.vcycle": (16, 0.2, 0.05), "gmg.graph_replay": (16, 16, 1)}, None),
    ({"amg.vcycle": (11, 0.2, 0.05), "amg.graph_replay": (11, 11, 1), "amg.graph_capture": (1, 1, 1)}, 100.0),
    ({"amg.vcycle": (20, 0.2, 0.05), "amg.graph_replay": (15, 15, 1)}, 75.0),
])
def test_amg_graph_share_reader(monkeypatch, table, share):
    from portbench.core import load_module
    from portbench.metrics import _program_spans

    monkeypatch.setattr(_program_spans, "table", lambda: table)
    assert load_module("metrics", "amg_graph_share").read({}) == share


def test_amg_graph_share_is_silent_on_the_cpu():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "amg_graph_share")
    assert m["workloads"] == ["contact_74k.newton"] and m["moves"] == "solve_ms"
    assert m["layer"] == "preconditioner" and m["source"] == "program_counter"
    res = _traced_small("contact_74k.newton")
    assert "amg_graph_share" not in res["metrics"] and "cg_its" in res["metrics"]
