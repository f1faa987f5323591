"""Conversions between the flat vector and the padded class stack per GMG
V-cycle: calls of the port's spans lattice.to_blocked and
lattice.from_blocked over calls of gmg.vcycle, from the process's trace
table (set-up and profiled requests included).  A blocked-I/O cycle
converts twice, at its level-0/1 transfer, and each request twice more;
a cycle that converts around every fine product reads several times that."""

from portbench.metrics._program_spans import table


def read(rec):
    t = table()
    vcycle = t.get("gmg.vcycle")
    conversions = [t[k][0] for k in ("lattice.to_blocked", "lattice.from_blocked") if k in t]
    if not vcycle or not vcycle[0] or not conversions:
        return None
    return sum(conversions) / vcycle[0]
