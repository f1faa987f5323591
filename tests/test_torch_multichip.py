"""The port's dryrun_multichip (dolfinx_mpc_tpu_torch/parallel/dryrun.py)
on 8 gloo ranks on the CPU: the six scenarios of the JAX package's dry run
(__graft_entry__.py) at its sizes pass their own assertions inside the
ranks, and their CG counts are the JAX package's on 8 devices, as
MULTICHIP_r05.json records them (within 2)."""

import json
import re
from pathlib import Path

import pytest

from dolfinx_mpc_tpu_torch.parallel.dryrun import dryrun_multichip, report

ROOT = Path(__file__).resolve().parents[1]
SCENARIOS = ("lattice-halo", "lattice-2d", "lattice-gmg", "lattice-gmg-3level", "general", "contact")


def _recorded_counts():
    """The six CG counts of MULTICHIP_r05.json's dry-run lines."""
    tail = json.loads((ROOT / "MULTICHIP_r05.json").read_text())["tail"]
    out = {}
    for line in tail.splitlines():
        m = re.match(r"dryrun_multichip\(8\) ([\w-]+)[ :(].*?CG its=(\d+)", line)
        if m:
            out[m.group(1)] = int(m.group(2))
    return out


@pytest.fixture(scope="module")
def dryrun():
    return dryrun_multichip(8, backend="gloo", device="cpu")


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_counts_match_multichip_r05(dryrun, scenario):
    ref = _recorded_counts()
    assert set(ref) == set(SCENARIOS)
    for rank_out in dryrun:
        assert abs(rank_out[scenario]["its"] - ref[scenario]) <= 2, (scenario, rank_out[scenario]["its"], ref)


def test_ranks_agree_and_report(dryrun):
    """Every rank saw the same counts and residuals; the report has the JAX
    package's six lines."""
    for rank_out in dryrun[1:]:
        for s in SCENARIOS:
            assert rank_out[s]["its"] == dryrun[0][s]["its"]
            if "rnorm" in rank_out[s]:
                assert rank_out[s]["rnorm"] == dryrun[0][s]["rnorm"]
    lines = report(8, dryrun[0])
    assert [line.split(" ")[1].rstrip(":") for line in lines] == list(SCENARIOS)
    assert dryrun[0]["general"]["window"] < dryrun[0]["general"]["dofs"]
