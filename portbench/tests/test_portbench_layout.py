"""BENCHMARK.json against the contract's form, every file found by name,
a new configuration, traffic mix and metric picked up as files alone, and
no JAX or JAX package anywhere in the harness."""

import ast
import json
import re
import shutil
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
    assert c.chips == 1 and len(cell["why"]) <= 200
    assert {m["name"] for m in c.end_to_end} >= {"setup_s", "solve_ms"} and c.per_layer
    assert (ROOT / "portbench" / "configs" / f"{c.config}.py").is_file()
    assert (ROOT / "portbench" / "reference" / f"{c.config}.py").is_file()
    assert c.limits


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


def test_run_loads_no_jax():
    """A whole run at a tiny size on the CPU, then the top-level names in
    sys.modules (compared whole: dolfinx_mpc_tpu_torch is the port)."""
    out = _python(f"""
        import dataclasses, json, sys, time
        sys.path.insert(0, {str(ROOT)!r})
        from portbench.core import load_cell, run
        for name, size in (("p1_n216.solve", {{"n": 8}}), ("contact_74k.newton", {{"nb": 2, "nt": 2}})):
            cell = load_cell(name)
            cell = dataclasses.replace(cell, traffic={{**cell.traffic, "size": size}})
            code, res = run(cell, 7, 0.2, 0, time.time(), device="cpu", log=lambda s: None)
            assert code == 0 and res["correct"], res
        print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
        """, ROOT)
    tops = set(json.loads(out.splitlines()[-1]))
    assert "dolfinx_mpc_tpu_torch" in tops and not tops & FORBIDDEN


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
    """A configuration, a traffic mix, a limits file and a metric added as
    new files and BENCHMARK.json entries, in a copy of the benchmark, run
    without an edit to any file that was there."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    shutil.copy(pb / "configs" / "periodic_p1.json", pb / "configs" / "periodic_p1_copy.json")
    shutil.copy(pb / "configs" / "periodic_p1.py", pb / "configs" / "periodic_p1_copy.py")
    shutil.copy(pb / "reference" / "periodic_p1.py", pb / "reference" / "periodic_p1_copy.py")
    traffic = json.loads((pb / "traffic" / "p1_n216.solve.json").read_text())
    traffic["size"] = {"n": 8}
    (pb / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (pb / "limits" / "copy.tiny.json").write_text((pb / "limits" / "p1_n216.solve.json").read_text())
    (pb / "metrics" / "requests_seen.py").write_text("def read(rec):\n    return float(len(rec['requests']))\n")
    bench["configs"].append({"name": "periodic_p1_copy", "source": "https://example.org", "reduced": [],
                             "file": "portbench/configs/periodic_p1_copy.json", "why": "test"})
    bench["workloads"].append({"name": "copy.tiny", "config": "periodic_p1_copy", "traffic": "tiny", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "Krylov", "moves": "solve_ms",
                               "workloads": ["copy.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _python(f"""
        import json, sys, time
        sys.path.insert(0, {str(tmp_path)!r})
        sys.path.append({str(ROOT)!r})
        import portbench.core as core
        assert core.ROOT == __import__("pathlib").Path({str(tmp_path)!r})
        cell = core.load_cell("copy.tiny")
        code, res = core.run(cell, 3, 0.2, 1, time.time(), device="cpu", log=lambda s: None)
        print(json.dumps(res))
        """, tmp_path)
    res = json.loads(out.splitlines()[-1])
    assert res["correct"] and res["metrics"]["requests_seen"]["value"] == res["attempted"]


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
