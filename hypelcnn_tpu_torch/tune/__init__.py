"""Hyperparameter search."""
