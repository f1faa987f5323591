"""One run of one cell: set-up, the measured window, the judgement.

Everything that belongs to a configuration, a traffic mix or a metric is
found by its name in BENCHMARK.json:
    configs/<config>.py     the problem class on the port (class Problem)
    configs/<config>.json   its sizes, forms, precision, solver stack, source
    reference/<config>.py   the plain reference (judge, control)
    traffic/<traffic>.json  the cell's size and request stream
    limits/<cell>.json      the limit of each number compared
    metrics/<metric>.py     read(record) -> number or None
"""

import gc
import importlib.util
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dolfinx_mpc_tpu")
SAMPLES = 16  # requests kept for the judgement, drawn from the seed
PROFILE_MIN_S = 1.0  # the traced run profiles requests before its window,
PROFILE_MIN_REQUESTS = 2  # at least this long and this many


@dataclass
class Cell:
    name: str
    config: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports untraced
    per_layer: list  # and traced


def load_cell(name, root=ROOT):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "portbench"
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name=name, config=w["config"], chips=w["chips"],
                cfg=json.loads((root / conf["file"]).read_text()),
                traffic=json.loads((here / "traffic" / f"{w['traffic']}.json").read_text()),
                limits=json.loads((here / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def load_module(kind, name, here=HERE):
    """portbench/<kind>/<name>.py as a module of its own."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (dolfinx_mpc_tpu_torch is the port, not the JAX package)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Reservoir:
    """A uniform sample of SAMPLES requests of the window, drawn from the seed."""

    def __init__(self, seed, size=SAMPLES):
        self.rng = random.Random(int(seed) * 1_000_003 + 17)
        self.size, self.kept = size, []

    def offer(self, k, out):
        if len(self.kept) < self.size:
            self.kept.append((k, out))
        else:
            j = self.rng.randrange(k + 1)
            if j < self.size:
                self.kept[j] = (k, out)


def kernel_trace(fn, sync, reps=20, flush_bytes=256 << 20):
    """{kernel name: [device seconds, launches]} of `reps` calls of fn(),
    from torch.profiler's device trace.  Each call follows a read of
    `flush_bytes` (five times the L2), which leaves the L2 holding clean
    lines of its own: every call reads its operands from HBM, and no dirty
    line is written back while it runs.  The read's own kernel is under its
    own name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.ones(flush_bytes // 4, dtype=torch.float32, device="cuda")
    fn()
    sync()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(reps):
        flush.sum()
        fn()
    sync()
    prof.stop()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            s, c = out.get(e.name, (0.0, 0))
            out[e.name] = [s + (e.time_range.end - e.time_range.start) / 1e6, c + 1]
    return out


def decide(numbers, limits, failed):
    """(checks, correct): each number compared beside its limit, and
    whether the run is correct: no request failed, and every number that
    has a limit was read and lies at or under it.  Numbers without a limit
    are readings only."""
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    correct = failed == 0 and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return checks, bool(correct)


def run(cell, seed, seconds, trace, t_start, device="cuda", log=print):
    """One run; returns (exit code, result dict or None).  `t_start` is the
    host clock at process start; info lines go to `log`."""
    import torch

    from .trace import Tracer, reduce_profile

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tracer = Tracer("off", sync)
    problem_mod = load_module("configs", cell.config)
    reference = load_module("reference", cell.config)
    build_s = 0.0  # the kernel library's build, where this run built it
    if on_card:
        from dolfinx_mpc_tpu_torch._build import BUILD_DIR, load_kernels

        had = set(BUILD_DIR.glob("*.so")) if BUILD_DIR.exists() else set()
        t0 = time.perf_counter()
        load_kernels()
        load_s = time.perf_counter() - t0
        built = set(BUILD_DIR.glob("*.so")) - had
        log(f"kernel library: {'built in this run' if built else 'found built'}, {load_s:.3f} s")
        if built:
            build_s = load_s
    problem = problem_mod.Problem(cell.cfg, cell.traffic, seed, dev, tracer)
    from .inputs import WARM

    problem.request(WARM)
    sync()
    setup_s = time.time() - t_start
    if build_s:
        # a checkout's first run builds the library; setup_s keeps it, as
        # a run that compiles counts its compilation, and this line sets it apart
        log(f"set-up without the kernel build {setup_s - build_s:.3f} s (the build {build_s:.3f} s)")
    log(f"set-up {setup_s:.3f} s; spans {json.dumps(tracer.setup)}; problem {json.dumps(problem.describe())}")

    reservoir, reqs, prof, profile = Reservoir(seed), [], None, None
    if trace:
        # the traced run profiles its first requests, then runs its window
        # with the spans timed; the profile is read once the window is over
        from torch.profiler import ProfilerActivity, profile as torch_profile

        tracer.mode = "profile"
        prof = torch_profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else []))
        prof.start()
        t0, its = time.perf_counter(), 0
        k = 0
        while time.perf_counter() - t0 < PROFILE_MIN_S or k < PROFILE_MIN_REQUESTS:
            out = problem.request(WARM + 1 + k)
            its += out["its"]
            k += 1
        del out
        sync()
        prof.stop()
        tracer.take()
        tracer.mode = "timed"
    t0 = time.perf_counter()
    while True:
        ta = time.perf_counter()
        out = problem.request(len(reqs))
        tb = time.perf_counter()
        reqs.append({"ms": 1e3 * (tb - ta), "its": out["its"], "ok": bool(out["converged"]),
                     "spans": tracer.take()})
        reservoir.offer(len(reqs) - 1, out)
        del out
        if tb - t0 >= seconds:
            break
    window_s = tb - t0
    leaked = forbidden_modules()
    if leaked:
        print(f"the window ran with {', '.join(leaked)} in sys.modules", file=sys.stderr)
        return 3, None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    hist = {}
    for r in reqs:
        hist[r["its"]] = hist.get(r["its"], 0) + 1
    log(f"peak device memory {peak} bytes; {len(reqs)} requests in {window_s:.3f} s; "
        f"CG iterations: requests {json.dumps(dict(sorted(hist.items())))}")
    probes = {}
    if prof is not None:
        profile = reduce_profile(prof, tracer.names)
        if profile is not None:
            profile["its"] = its
        del prof
    if trace and on_card:
        probes = {name: kernel_trace(fn, sync) for name, fn in problem.probes().items()}
    kept = problem.finish(reservoir.kept)
    judged = len(kept)
    described = problem.describe()
    del problem, reservoir
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers, counts = reference.judge(cell.cfg, cell.traffic, seed, kept, dev)
    del kept
    log(f"readings over {judged} requests of the window: {json.dumps(numbers)}")
    failed = sum(not r["ok"] for r in reqs)
    checks, correct = decide(numbers, cell.limits, failed)
    record = {"setup_s": setup_s, "window_s": window_s, "requests": reqs, "setup_spans": tracer.setup,
              "profile": profile, "probes": probes, "sizes": {**described, **counts}, "traffic": cell.traffic}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_module("metrics", m["name"]).read(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(reqs), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else dev.type,
                         "kind": torch.cuda.get_device_name(0) if on_card else dev.type,
                         "count": cell.chips, "memory_peak_bytes": int(peak)}}
    if trace and profile is not None:
        result["device"].update(busy_s=profile["busy_s"], window_s=profile["window_s"])
        result["breakdown"] = {"device_ops": profile["device_ops"], "idle_gaps": profile["idle_gaps"]}
    result["checks"] = checks
    return 0, result
