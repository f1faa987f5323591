"""The port's own spans and counters: the trace table of
dolfinx_mpc_tpu_torch.utils.timing (trace_timings(), {name: (calls, total,
max)}), totalled over the run's process, set-up and profiled requests
included.  Empty for a port that keeps no such table."""


def table():
    try:
        from dolfinx_mpc_tpu_torch.utils.timing import trace_timings
    except ImportError:
        return {}
    return trace_timings()


def mean_ms(name):
    """Mean ms per call of the span `name`, None where it has no calls."""
    calls, total, _ = table().get(name, (0, 0.0, 0.0))
    return 1e3 * total / calls if calls else None
