"""The benchmark of dolfinx_mpc_tpu_torch (see README.md)."""
