"""The reader of bell_plan_share, beside the readers of the port's other
spans and counters (test_portbench_program_spans.py): None without the
counters bell.plan_hit and bell.plan_miss, hits / (hits + misses) in %
with them, and in a traced run of the tiny .newton cell on the CPU, where
the set-up's conversion is the one miss."""

import pytest

from test_portbench_layout import BENCH
from test_portbench_program_spans import _traced_small


@pytest.mark.parametrize("table,share", [
    ({}, None),
    ({"bell.upload": (3, 0.1, 0.05), "bell.upload_bytes": (3, 3e6, 1e6)}, None),
    ({"bell.plan_miss": (1, 1, 1)}, 0.0),
    ({"bell.plan_hit": (3, 3, 1)}, 100.0),
    ({"bell.plan_miss": (1, 1, 1), "bell.plan_hit": (3, 3, 1)}, 75.0),
])
def test_plan_share_reader(monkeypatch, table, share):
    from portbench.core import load_module
    from portbench.metrics import _program_spans

    monkeypatch.setattr(_program_spans, "table", lambda: table)
    assert load_module("metrics", "bell_plan_share").read({}) == share


def test_plan_share_in_a_traced_newton_run():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "bell_plan_share")
    assert m["workloads"] == ["contact_74k.newton"] and m["moves"] == "solve_ms"
    res = _traced_small("contact_74k.newton")
    assert 50.0 <= res["metrics"]["bell_plan_share"]["value"] < 100.0  # one miss, then hits
