"""Mean ms per call of bell_arrays_from_scipy, the host packing of the
padded 8x128 BELL tiles (the port's span bell.pack)."""

from portbench.metrics._program_spans import mean_ms


def read(rec):
    return mean_ms("bell.pack")
