"""Mean ms per request of the BELL conversion: to_scipy and
bell_from_scipy (the packed layout K8 reads included)."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "bell_convert")
