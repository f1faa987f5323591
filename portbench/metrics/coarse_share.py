"""Share in % of the GMG V-cycle's host time spent in its coarse solve:
the port's span gmg.coarse over gmg.vcycle (host clock, no synchronize:
the time to enqueue, which is the time taken where the host sets the pace)."""

from portbench.metrics._program_spans import table


def read(rec):
    t = table()
    coarse, vcycle = t.get("gmg.coarse"), t.get("gmg.vcycle")
    if not coarse or not coarse[0] or not vcycle or not vcycle[1]:
        return None
    return 100.0 * coarse[1] / vcycle[1]
