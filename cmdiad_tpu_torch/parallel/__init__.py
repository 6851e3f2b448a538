"""Multi-device runs of the port over ``torch.distributed``: one process a
rank, each with its own device (the JAX package's ``parallel/`` package,
whose single controller drives a whole mesh)."""
