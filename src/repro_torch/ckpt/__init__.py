"""Checkpoints of the torch port (the JAX package's on-disk layout)."""
