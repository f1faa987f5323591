"""A copy of the benchmark with new configurations and cells added as new
files and BENCHMARK.json entries only, as a later change adds them:

    python3 portbench/tests/newcells.py <dir> [--toy-chips R]

copies portbench/ and BENCHMARK.json into <dir>, links the port's
package there, and adds
  - `periodic_p1_copy`, a new configuration (periodic_p1's files under a
    new name), and its one-chip cell `p1copy.solve` with a per-layer
    metric of its own, `requests_seen`;
  - the toy `allreduce` (tests/toy/) and its cell `allreduce.ranks` on R
    ranks (default 4), with the per-layer metric `allreduce_ms`.
Then `python3 <dir>/portbench/run.py --workload allreduce.ranks ...` runs
the toy's ranks on R cards."""

import argparse
import hashlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TOY = Path(__file__).resolve().parent / "toy"
P1_COPY = ("periodic_p1_copy", "p1copy.solve")
TOY_CELL = ("allreduce", "allreduce.ranks")
NEW_METRICS = ("requests_seen", "allreduce_ms")
NEW_NAMES = P1_COPY + TOY_CELL + NEW_METRICS


def hashes(root):
    """{relative path: sha256} of BENCHMARK.json and every file under portbench/."""
    root = Path(root)
    files = [root / "BENCHMARK.json"] + sorted(p for p in (root / "portbench").rglob("*") if p.is_file())
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest() for p in files}


def _add(path, text):
    if path.exists():
        raise FileExistsError(f"{path} is already in the copy: a new cell adds files only")
    path.write_text(text)


def make_copy(dst, toy_chips=4):
    """The copy in `dst`; returns the hashes of the files it had before
    anything was added."""
    dst = Path(dst)
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "toy_pids"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "dolfinx_mpc_tpu_torch").symlink_to(ROOT / "dolfinx_mpc_tpu_torch")
    before = hashes(dst)
    pb = dst / "portbench"
    bench = json.loads((dst / "BENCHMARK.json").read_text())

    config, cell = P1_COPY
    for kind, ext in (("configs", "json"), ("configs", "py"), ("reference", "py")):
        _add(pb / kind / f"{config}.{ext}", (pb / kind / f"periodic_p1.{ext}").read_text())
    _add(pb / "traffic" / f"{cell}.json", (pb / "traffic" / "p1_n216.solve.json").read_text())
    _add(pb / "limits" / f"{cell}.json", (pb / "limits" / "p1_n216.solve.json").read_text())
    _add(pb / "metrics" / "requests_seen.py", "def read(rec):\n    return float(len(rec['requests']))\n")
    bench["configs"].append({"name": config, "source": "https://example.org", "reduced": [],
                             "file": f"portbench/configs/{config}.json", "why": "a new configuration"})
    bench["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1,
                               "why": "a new one-chip cell"})
    bench["per_layer"].append({"name": "requests_seen", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "Krylov", "moves": "solve_ms",
                               "workloads": [cell]})

    config, cell = TOY_CELL
    for src in sorted(p for p in TOY.rglob("*") if p.is_file() and "__pycache__" not in p.parts):
        text = src.read_text()
        if src.name == f"{config}.json" and src.parent.name == "configs":
            text = json.dumps({**json.loads(text), "ranks": toy_chips}, indent=2)
        _add(pb / src.relative_to(TOY), text)
    bench["configs"].append({"name": config, "source": "https://example.org", "reduced": [],
                             "file": f"portbench/configs/{config}.json", "why": "a toy of the harness's ranks"})
    bench["workloads"].append({"name": cell, "config": config, "traffic": config, "chips": toy_chips,
                               "why": "a multi-chip cell: one all-reduce per request"})
    bench["per_layer"].append({"name": "allreduce_ms", "unit": "ms", "better": "lower", "source": "program_span",
                               "layer": "collectives", "moves": "solve_ms", "workloads": [cell]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return before


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir")
    ap.add_argument("--toy-chips", type=int, default=4)
    args = ap.parse_args()
    make_copy(args.dir, args.toy_chips)
    print(f"copy with {', '.join(NEW_NAMES[:4])} in {args.dir}", file=sys.stderr)
