"""Run one cell of the benchmark of dolfinx_mpc_tpu_torch once, on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints information lines, then as its last
line of standard output one JSON object (correct, attempted, failed,
metrics, device, with --trace 1 breakdown, then checks: each number
compared beside its limit); the numbers compared also end standard error.
Exits non-zero, with no result, without enough cards, or if JAX or the JAX
package was loaded by the time the window closed."""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path.insert(0, str(ROOT))

    from portbench.core import load_cell, run

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()} (count {torch.cuda.device_count()}, "
          f"using {cell.chips}); torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    code, result = run(cell, args.seed, args.seconds, args.trace, T_START,
                       log=lambda s: print(s, flush=True))
    if result is None:
        return code
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
