"""BENCHMARK.json against the contract's form, every file found by name,
new configurations, cells and metrics (a four-chip cell among them) picked
up as new files and entries alone, and no JAX or JAX package anywhere in
the harness."""

import ast
import json
import re
import subprocess
import sys
import textwrap

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "dolfinx_mpc_tpu"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
                         + [m["name"] for m in METRICS])
def test_names(name):
    assert NAME.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=[w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    from portbench.core import load_cell

    c = load_cell(cell["name"])
    assert c.chips == cell["chips"] and len(cell["why"]) <= 200
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "solve_ms"} and c.per_layer
    assert (ROOT / "portbench" / "configs" / f"{c.config}.py").is_file()
    assert (ROOT / "portbench" / "reference" / f"{c.config}.py").is_file()
    assert c.limits


def test_chip_rule():
    """The benchmark contract's: a cell takes 1 or 4 chips, and at most max(1, cells // 4)
    of the cells take 4."""
    chips = [w["chips"] for w in BENCH["workloads"]]
    assert set(chips) <= {1, 4}
    assert chips.count(4) <= max(1, len(chips) // 4)


@pytest.mark.parametrize("config", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_states_its_small_size(config):
    """Every configuration file states the traffic size at which the CPU
    tests run it: "small", with the keys of its cells' sizes."""
    small = json.loads((ROOT / config["file"]).read_text())["small"]
    for w in BENCH["workloads"]:
        if w["config"] == config["name"]:
            size = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())["size"]
            assert set(small) == set(size), (small, size)


def test_configs_used_and_files_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert {c["name"] for c in BENCH["configs"]} == used and len(set(files)) == len(files)
    for f in files:
        assert f.startswith("portbench/") and (ROOT / f).is_file()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")), ids=lambda p: p.name)
def test_sources_import_no_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    if "reference" in path.parts:
        assert "dolfinx_mpc_tpu_torch" not in tops


def _python(code, cwd):
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=[w["name"] for w in BENCH["workloads"]])
def test_run_loads_no_jax(cell):
    """A whole run at the configuration's small size on the CPU, then the
    top-level names in sys.modules (compared whole: dolfinx_mpc_tpu_torch
    is the port, and is loaded wherever configs/<config>.py imports it)."""
    name = cell["name"]
    out = _python(f"""
        import dataclasses, json, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from portbench.core import load_cell, run
        cell = load_cell({name!r})
        cell = dataclasses.replace(cell, traffic={{**cell.traffic, "size": cell.cfg["small"]}})
        code, res = run(cell, 7, 0.2, 0, time.time(), device="cpu", log=lambda s: None)
        assert code == 0 and res["correct"], res
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """, ROOT)
    tops = set(json.loads(out.splitlines()[-1]))
    assert not tops & FORBIDDEN
    problem = ROOT / "portbench" / "configs" / f"{cell['config']}.py"
    if "dolfinx_mpc_tpu_torch" in {m.split(".")[0] for m in _imports(problem)}:
        assert "dolfinx_mpc_tpu_torch" in tops


def test_reference_loads_nothing_of_the_port():
    out = _python(f"""
        import json, sys
        sys.path.insert(0, {str(ROOT)!r})
        from portbench.core import load_module
        for name in {sorted({c["name"] for c in BENCH["configs"]})!r}:
            load_module("reference", name)
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """, ROOT)
    tops = set(json.loads(out.splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"dolfinx_mpc_tpu_torch"})


def test_new_files_are_picked_up(tmp_path):
    """A new configuration with a one-chip cell and a per-layer metric, and
    the toy `allreduce` on four ranks (gloo here), added to a copy of the
    benchmark as new files and BENCHMARK.json entries only
    (newcells.make_copy): the harness's reference and layout tests pass
    there for them, a traced run reports the new metric, and no file that
    was there changed."""
    from newcells import NEW_NAMES, hashes, make_copy

    before = make_copy(tmp_path, toy_chips=4)
    old, new = json.loads((ROOT / "BENCHMARK.json").read_text()), json.loads((tmp_path / "BENCHMARK.json").read_text())
    for key in old:  # BENCHMARK.json: entries added only
        assert new[key] == old[key] if not isinstance(old[key], list) else new[key][:len(old[key])] == old[key]
    # the tests of the new names and those of the whole benchmark (not this one again), meanwhile a traced run
    select = f"({' or '.join(NEW_NAMES)} or not [) and not test_new_files_are_picked_up"
    files = ["portbench/tests/test_portbench_reference.py", "portbench/tests/test_portbench_layout.py"]
    tests = subprocess.Popen([sys.executable, "-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider", "-p", "xdist",
                              "-n", "4", *files, "-k", select], cwd=tmp_path, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        out = _python(f"""
            import dataclasses, json, sys, time
            sys.path.insert(0, {str(tmp_path)!r})
            import portbench.core as core
            assert core.ROOT == __import__("pathlib").Path({str(tmp_path)!r})
            cell = core.load_cell("p1copy.solve")
            cell = dataclasses.replace(cell, traffic={{**cell.traffic, "size": cell.cfg["small"]}})
            code, res = core.run(cell, 3, 0.2, 1, time.time(), device="cpu", log=lambda s: None)
            print(json.dumps(res))
            """, tmp_path)
        log = tests.communicate(timeout=900)[0]
    finally:
        tests.kill()
        tests.wait()
    assert tests.returncode == 0, log[-6000:]
    passed = [line for line in log.splitlines() if line.startswith("PASSED")]
    for cell in ("p1copy.solve", "allreduce.ranks"):
        for test in ("reference_agrees_with_the_port", "control_is_not_correct", "broken_timed_path_is_not_correct",
                     "cell_found_by_name", "run_loads_no_jax"):
            assert any(f"test_{test}[{cell}" in line for line in passed), (cell, test, log[-3000:])
    assert any("test_chip_rule" in line for line in passed)
    traced = json.loads(out.splitlines()[-1])
    assert traced["correct"] and traced["metrics"]["requests_seen"]["value"] == traced["attempted"]
    after = hashes(tmp_path)
    changed = [f for f, h in before.items() if f != "BENCHMARK.json" and after.get(f) != h]
    assert not changed


def test_kernel_time_from_the_trace():
    """A roofline reads the named kernel's device time per launch from a
    probe's trace, and nothing where the kernel did not run."""
    from portbench.yardstick import kernel_ms, roofline_share

    probe = {"void bell_csr_matvec_kernel<float, 4>(int const*, ...)": [2e-4, 20],
             "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<unsigned char>>": [0.5, 20]}
    assert kernel_ms(probe, "bell_csr_matvec_kernel") == pytest.approx(0.01)
    assert kernel_ms(probe, "dia_matvec_kernel") is None and kernel_ms(None, "bell_csr_matvec_kernel") is None
    assert roofline_share(None, 8, 1) is None
    assert roofline_share(0.01, 3.35e7, 0) == pytest.approx(100.0)
