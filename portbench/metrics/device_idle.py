"""Share in % of the profiled window in which no operation ran on the
device (merged device intervals of torch.profiler's trace)."""


def read(rec):
    p = rec["profile"]
    if not p or not p["window_s"] or not p["busy_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
