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
import os
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
RANK_TIMEOUT_S = 300  # a multi-chip cell's process group: the longest wait in one collective
RANK_GRACE_S = 30  # what a rank has to end by itself: once its part is done, or once a peer has ended early
STOP = -1  # the index rank 0 broadcasts once its window is over


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


def device_peak(dev):
    """The most memory tensors have held on `dev` in this process (0 off the card)."""
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _rank_device(rank, device):
    """Rank r's device: the card cuda:r, or the CPU where the cell runs there (the tests)."""
    import torch

    return torch.device(f"cuda:{rank}") if torch.device(device).type == "cuda" else torch.device("cpu")


def _join_group(rank, world, dev, store):
    """This process as rank `rank` of the default process group: NCCL on a
    card, gloo on the CPU, met through the file store `store`."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // world))
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S), **kw)


def _after_window(dev):
    """Collective, once the window is over: (the fullest card's peak memory,
    {rank: forbidden top-level names} of the ranks that loaded any)."""
    import torch.distributed as dist

    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (device_peak(dev), forbidden_modules()))
    return max(p for p, _ in got), {r: names for r, (_, names) in enumerate(got) if names}


def _exit_with_parent():
    """End this process once its parent has gone (rank 0 killed from outside)."""
    import threading

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _rank_main(i, cell, seed, device, store):
    """Rank r = i + 1 > 0 of a multi-chip cell: builds its Problem on its
    own device, runs each request whose index rank 0 broadcasts, offers the
    window's to a Reservoir drawn from the seed as rank 0 does, then takes
    part in the gather after the window and in finish().  What it raises,
    torch.multiprocessing writes down with its traceback before the process
    ends, and so before the group's connections close."""
    import torch
    import torch.distributed as dist

    from .inputs import WARM
    from .trace import Tracer

    rank = i + 1
    _exit_with_parent()
    dev = _rank_device(rank, device)
    _join_group(rank, cell.chips, dev, store)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    problem = load_module("configs", cell.config).Problem(cell.cfg, cell.traffic, seed, dev, Tracer("off", sync))
    index, reservoir = torch.zeros(1, dtype=torch.int64, device=dev), Reservoir(seed)
    while True:
        dist.broadcast(index, 0)
        if (k := int(index)) == STOP:
            break
        out = problem.request(k)
        if k < WARM:  # a request of the window
            reservoir.offer(k, out)
        del out
    _, leaked = _after_window(dev)
    if not leaked:
        problem.finish(reservoir.kept)
    dist.destroy_process_group()


class Ranks:
    """Ranks 1 .. R-1 of a cell with `chips` R > 1, seen from rank 0: this
    process, on cuda:0.  Started by torch.multiprocessing (spawn), each on
    cuda:r (the CPU in the tests), and joined with rank 0 in one default
    process group through a file store in a temporary directory.  A rank
    that ends before close() ends the run: a watcher prints its traceback
    and ends the others, and rank 0's waiting collective raises (gloo);
    where it waits on (NCCL), rank 0 ends with exit code 3 after
    RANK_GRACE_S."""

    def __init__(self, cell, seed, device):
        import tempfile
        import threading

        import torch
        import torch.multiprocessing as mp

        self.tmp = tempfile.TemporaryDirectory(prefix="portbench_ranks_")
        store = os.path.join(self.tmp.name, "store")
        self.ctx = mp.start_processes(_rank_main, args=(cell, seed, device, store), nprocs=cell.chips - 1,
                                      join=False, start_method="spawn")
        self.closing = threading.Event()
        self.watcher = threading.Thread(target=self._watch, daemon=True)
        self.watcher.start()
        try:
            self.dev = _rank_device(0, device)
            _join_group(0, cell.chips, self.dev, store)
            self.index = torch.zeros(1, dtype=torch.int64, device=self.dev)
        except BaseException:
            self.close(clean=False)
            raise

    def announce(self, k):
        """Broadcast the index of the request every rank runs next (STOP: none)."""
        import torch.distributed as dist

        self.index.fill_(k)
        dist.broadcast(self.index, 0)

    def _watch(self):
        """The one joiner of the ranks: the first that fails ends the others
        (ProcessContext.join)."""
        try:
            while not self.ctx.join(0.2):
                pass
        except Exception as e:
            print(f"a rank ended early, and with it the run (process i is rank i + 1): {e}", file=sys.stderr, flush=True)
            if not self.closing.wait(RANK_GRACE_S):
                print("rank 0 still waits on a collective: exit 3", file=sys.stderr, flush=True)
                os._exit(3)

    def close(self, clean):
        """Ends the process group and every rank: where `clean`, each rank
        is given RANK_GRACE_S to end by itself.  True where every rank
        ended with exit code 0."""
        import torch.distributed as dist

        self.closing.set()
        if dist.is_initialized():
            dist.destroy_process_group()
        if clean:
            self.watcher.join(RANK_GRACE_S)
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
        self.watcher.join()
        codes = [p.exitcode for p in self.ctx.processes]
        self.tmp.cleanup()
        if any(c != 0 for c in codes):
            print(f"ranks 1-{len(codes)} ended with exit codes {codes}", file=sys.stderr, flush=True)
        return clean and all(c == 0 for c in codes)


def run(cell, seed, seconds, trace, t_start, device="cuda", log=print):
    """One run; returns (exit code, result dict or None).  `t_start` is the
    host clock at process start; info lines go to `log`.  A cell with
    `chips` R > 1 runs R ranks: this process is rank 0 and measures; see
    Ranks."""
    import torch

    from .trace import Tracer

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
    loaded = (problem_mod, reference, tracer, sync, build_s)
    if cell.chips == 1:
        return _measure(cell, seed, seconds, trace, t_start, dev, loaded, log, None)
    ranks = Ranks(cell, seed, device)
    try:
        code, result = _measure(cell, seed, seconds, trace, t_start, ranks.dev, loaded, log, ranks)
    except BaseException:
        ranks.close(clean=False)
        raise
    if not ranks.close(clean=True):
        return 3, None
    return code, result


def _measure(cell, seed, seconds, trace, t_start, dev, loaded, log, ranks):
    """Set-up, the window and the judgement on rank 0, with what run()
    loaded before the kernel library; `ranks` None for one chip."""
    import torch

    from .trace import reduce_profile

    problem_mod, reference, tracer, sync, build_s = loaded
    on_card = dev.type == "cuda"
    problem = problem_mod.Problem(cell.cfg, cell.traffic, seed, dev, tracer)
    from .inputs import WARM

    if ranks:
        ranks.announce(WARM)
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
            if ranks:
                ranks.announce(WARM + 1 + k)
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
        if ranks:
            ranks.announce(len(reqs))
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
    if ranks is None:
        leaked = forbidden_modules()
        if leaked:
            print(f"the window ran with {', '.join(leaked)} in sys.modules", file=sys.stderr)
            return 3, None
        peak = device_peak(dev)
    else:
        ranks.announce(STOP)
        peak, leaked = _after_window(dev)  # the fullest card's peak; every rank's modules
        if leaked:
            for r, names in leaked.items():
                print(f"rank {r}: the window ran with {', '.join(names)} in sys.modules", file=sys.stderr)
            return 3, None
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
