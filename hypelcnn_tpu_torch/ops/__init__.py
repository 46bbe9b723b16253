"""Tensor ops with a plain PyTorch version and, where it pays, a hand-written kernel."""
