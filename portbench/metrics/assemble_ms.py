"""Mean ms per request of the general assembly: assemble_matrix and the
right-hand side (assemble_vector, apply_lifting, set_bc)."""

from portbench.metrics._spans import mean_ms


def read(rec):
    return mean_ms(rec, "assemble")
