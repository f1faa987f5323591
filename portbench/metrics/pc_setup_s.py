"""Seconds of the preconditioner's set-up (GMG hierarchy and LatticeGMG, or
smoothed-aggregation AMG), host clock after a synchronize."""


def read(rec):
    return rec["setup_spans"].get("pc_setup")
