"""Mean CG iterations per request (la/solvers.py cg's own count)."""


def read(rec):
    its = [r["its"] for r in rec["requests"]]
    return sum(its) / len(its) if its else None
