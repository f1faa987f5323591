"""Mean ms per call of CSRMatrix.to_scipy, the download of the assembled
matrix into a scipy CSR that the BELL conversion starts from (the port's
span csr.to_scipy)."""

from portbench.metrics._program_spans import mean_ms


def read(rec):
    return mean_ms("csr.to_scipy")
