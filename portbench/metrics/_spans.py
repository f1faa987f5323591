"""Span means over the traced window's requests."""


def mean_ms(rec, name):
    reqs = [r for r in rec["requests"] if name in r["spans"]]
    return 1e3 * sum(r["spans"][name] for r in reqs) / len(reqs) if reqs else None
