"""Distributed execution on torch.distributed ranks: the sharded lattice
path (lattice_spmd.py) and the general cell-sharded path (spmd.py).

Counterpart of ``dolfinx_mpc_tpu/parallel``: the JAX package's one
``shard_map`` program over a device mesh becomes one process per rank
(launch.py:run_ranks), and the collectives it calls become comm.py's
RankGrid over a gloo or NCCL process group.
"""

from .lattice_spmd import ShardedLatticeProblem
from .launch import run_ranks
from .spmd import ShardedLinearProblem, make_device_mesh

__all__ = ["ShardedLatticeProblem", "ShardedLinearProblem", "make_device_mesh", "run_ranks"]
