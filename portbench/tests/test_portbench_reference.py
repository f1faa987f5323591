"""The comparison that decides `correct`, on the CPU, each cell at its
configuration's "small" size: the plain reference agrees with the port's
plain path, the control (the reference in the precision below the
configuration's) comes out not correct, and so does a run whose timed path
is broken underneath by each fault the configuration can have (its
"faults", each a file faults/<fault>.py)."""

import dataclasses
import json
import time

import pytest
import torch

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (3, 2 ** 31 + 11)
# contact_tied's path that keeps the set-up's operator and changes only the
# load (a traffic with "reassemble" false); no cell runs it yet
ONE_OPERATOR = {"reassemble": False, "draws": {"top_scale": {"uniform": [0.5, 1.5]}}}
CASES = CELLS + ["contact_74k.one_operator"]
# what a configuration without a "faults" key can have: the port's CG and backsubstitution
PORT_FAULTS = ["unchanged_state", "altered_answer"]


def small(name):
    from portbench.core import load_cell

    if name == "contact_74k.one_operator":
        cell = load_cell("contact_74k.newton")
        cell = dataclasses.replace(cell, name=name, traffic={**cell.traffic, **ONE_OPERATOR})
    else:
        cell = load_cell(name)
    return dataclasses.replace(cell, traffic={**cell.traffic, "size": cell.cfg["small"]})


def run_small(name, seed, seconds=0.3, trace=0):
    from portbench.core import run

    code, res = run(small(name), seed, seconds, trace, time.time(), device="cpu", log=lambda s: None)
    assert code == 0
    return res


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CASES)
def test_reference_agrees_with_the_port(name, seed):
    res = run_small(name, seed)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1, res
    assert list(res)[-1] == "checks"
    for c in res["checks"].values():
        assert 0.0 <= c["value"] <= c["limit"]


def test_same_seed_same_inputs():
    from portbench.inputs import draw, probe_vector

    d = BENCH and json.loads((ROOT / "portbench" / "traffic" / "contact_74k.newton.json").read_text())["draws"]
    assert draw(d, 2 ** 33, 5) == draw(d, 2 ** 33, 5) != draw(d, 2 ** 33, 6)
    assert torch.equal(probe_vector(9, 1, 7, "cpu", torch.float64), probe_vector(9, 1, 7, "cpu", torch.float64))


@pytest.mark.parametrize("name", CASES)
def test_control_is_not_correct(name):
    from portbench.control import readings

    for seed in SEEDS:
        numbers, correct = readings(small(name), seed, torch.device("cpu"))
        assert not correct, numbers


@pytest.mark.parametrize("numbers, failed, correct", [
    ({"a": 1.0, "b": 2.0}, 0, True),
    ({"a": 1.0, "b": 2.0, "reading": 9.0}, 0, True),
    ({"a": 1.5, "b": 2.0}, 0, False),
    ({"a": 1.0}, 0, False),
    ({"a": float("nan"), "b": 2.0}, 0, False),
    ({"a": 1.0, "b": 2.0}, 1, False),
], ids=["under", "reading_only", "over", "missing", "nan", "failed_request"])
def test_one_decision(numbers, failed, correct):
    """The rule that decides `correct`, which the run and the control share:
    every number with a limit read and at or under it, no request failed; a
    number without a limit is a reading only."""
    from portbench.core import decide

    checks, ok = decide(numbers, {"a": 1.0, "b": 2.0}, failed)
    assert ok is correct and list(checks) == ["a", "b"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in CASES for f in small(n).cfg.get("faults", PORT_FAULTS)])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    from portbench.core import load_module

    load_module("faults", fault, here=ROOT / "portbench" / "tests").apply(monkeypatch)
    res = run_small(name, SEEDS[1], seconds=0.1)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(name, card):
    """The control at the cell's own size on the card, three seeds."""
    from portbench.control import readings
    from portbench.core import load_cell

    for seed in (5, 6, 7):
        numbers, correct = readings(load_cell(name), seed, card)
        assert not correct, numbers
