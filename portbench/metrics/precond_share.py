"""Share in % of the requests' wall time spent inside the preconditioner's
M(r) calls (host clock, a synchronize on either side of each call)."""


def read(rec):
    reqs = [r for r in rec["requests"] if "precond" in r["spans"]]
    if not reqs:
        return None
    return 100.0 * sum(r["spans"]["precond"] for r in reqs) / sum(r["spans"]["request"] for r in reqs)
