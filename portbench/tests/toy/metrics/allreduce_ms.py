"""Mean ms per request inside the toy's all-reduce (timed spans)."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "all_reduce")
