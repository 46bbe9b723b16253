"""Scenes and dataset loaders."""
