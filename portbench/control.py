"""Read the numbers compared from the control: the plain reference put in
the program's place in the precision below the configuration's.  It must
come out not correct.  Not part of the benchmark's runs.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--cpu]

Prints one JSON line per seed: the numbers, their limits and `correct`."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed, device):
    """(numbers, correct) of the control on as many requests of a run
    seeded `seed` as a run judges, by the run's own decision."""
    from portbench.core import SAMPLES, decide, load_module

    ref = load_module("reference", cell.config)
    kept = ref.control(cell.cfg, cell.traffic, seed, list(range(SAMPLES)), device)
    numbers, _ = ref.judge(cell.cfg, cell.traffic, seed, kept, device)
    return numbers, decide(numbers, cell.limits, failed=0)[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.core import load_cell

    cell = load_cell(args.workload)
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cpu" if args.cpu else "cuda")
    for seed in args.seeds:
        t0 = time.time()
        numbers, correct = readings(cell, seed, dev)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": numbers, "limits": cell.limits,
                          "correct": correct, "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
