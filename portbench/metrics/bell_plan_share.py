"""% of the BELL conversions of a canonical CSR that a plan of an already
converted sparsity pattern served: the port's counters bell.plan_hit and
bell.plan_miss, hits / (hits + misses)."""

from portbench.metrics._program_spans import table


def read(rec):
    t = table()
    hits, misses = (t.get(name, (0, 0, 0))[0] for name in ("bell.plan_hit", "bell.plan_miss"))
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
