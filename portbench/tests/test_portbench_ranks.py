"""The harness's ranks on the CPU (gloo, two ranks), with the toy
`allreduce` in a copy of the benchmark (newcells.make_copy): a run through
core.run is correct and reports the fullest rank's peak memory; a rank
that raises ends the run non-zero, with no result, and leaves no process
behind."""

import json
import os
import subprocess
import sys
import time

import pytest

from newcells import TOY_CELL, make_copy

# run as a file: the spawned ranks run its top level too, so each reads
# the peak that `peak` gives it, and the result shows which one was kept
SCRIPT = """
import dataclasses, json, sys, time
sys.path.insert(0, {root!r})
import portbench.core as core


def peak(dev):
    import torch.distributed as dist

    return 1000 + dist.get_rank()


core.device_peak = peak

if __name__ == "__main__":
    cell = core.load_cell({cell!r})
    cell = dataclasses.replace(cell, traffic={{**cell.traffic, "size": cell.cfg["small"], **{extra!r}}})
    code, res = core.run(cell, 2 ** 31 + 3, 0.5, 0, time.time(), device="cpu", log=lambda s: None)
    print(json.dumps({{"code": code, "result": res}}))
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("ranks")
    make_copy(root, toy_chips=2)
    return root


def _run(root, extra, timeout):
    pids = root / "build" / "portbench" / "toy_pids"
    for p in pids.glob("*") if pids.exists() else ():
        p.unlink()
    script = root / "run_toy.py"
    script.write_text(SCRIPT.format(root=str(root), cell=TOY_CELL[1], extra=extra))
    res = subprocess.run([sys.executable, str(script)], cwd=root, capture_output=True, text=True, timeout=timeout)
    return res, [int(p.read_text()) for p in sorted(pids.glob("*"))]


def _gone(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_two_ranks_are_correct(copy):
    res, pids = _run(copy, {}, 300)
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.splitlines()[-1])
    r = out["result"]
    assert out["code"] == 0 and r["correct"] and r["failed"] == 0 and r["attempted"] >= 1, r
    assert r["device"]["count"] == 2
    assert r["device"]["memory_peak_bytes"] == 1001  # rank 1's, the larger
    assert len(pids) == 2 and os.getpid() not in pids and all(_gone(p) for p in pids)


def test_a_raising_rank_ends_the_run(copy):
    t0 = time.time()
    res, pids = _run(copy, {"raise_on_rank": 1}, 120)
    assert res.returncode != 0 and time.time() - t0 < 120
    assert not any(line.lstrip().startswith("{") for line in res.stdout.splitlines()), res.stdout
    assert "rank 1 raises" in res.stderr
    deadline = time.time() + 5
    while not all(_gone(p) for p in pids) and time.time() < deadline:
        time.sleep(0.2)
    assert len(pids) == 2 and all(_gone(p) for p in pids)
