"""Training runtime (checkpoints so far)."""
