"""Interchange with the JAX package's checkpoints."""
