"""The port's demos: the JAX package's demos (``demos/``) on PyTorch.

Each module has ``main(..., device="cuda")`` with the JAX demo's sizes and
self-checks, and returns its solution; run one with
``python -m dolfinx_mpc_tpu_torch.demos.<name>`` from the repository root
(``--cpu`` runs it on the CPU).  ``create_and_export_mesh`` writes the gmsh
files of the two disconnect demos.  Demos with an ``info=`` argument
fill that dict with their solver counts.
"""
