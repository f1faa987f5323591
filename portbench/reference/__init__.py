"""Plain PyTorch / NumPy references of the configurations.  Nothing here
imports the port, the JAX package or JAX: each reference works the
constrained system out again from the benchmark's own inputs."""
