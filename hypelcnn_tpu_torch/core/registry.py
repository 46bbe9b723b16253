"""Name -> component registries.

The same lookup functions and names as ``hypelcnn_tpu/core/registry.py``,
plus the dotted-path escape hatch for user plugins (``package.module.Class``).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict

_MODEL_REGISTRY: Dict[str, Callable] = {}
_LOADER_REGISTRY: Dict[str, Callable] = {}


def register_model(name: str):
    def deco(cls):
        _MODEL_REGISTRY[name] = cls
        return cls
    return deco


def register_loader(name: str):
    def deco(cls):
        _LOADER_REGISTRY[name] = cls
        return cls
    return deco


def _resolve(registry: Dict[str, Callable], name: str, kind: str):
    if name in registry:
        return registry[name]
    if "." in name:
        module_name, _, class_name = name.rpartition(".")
        return getattr(importlib.import_module(module_name), class_name)
    raise KeyError(f"Unknown {kind} {name!r}; known: {sorted(registry)}")


def get_model_from_name(model_name: str):
    """Instantiate a model plugin by name."""
    import hypelcnn_tpu_torch.models  # noqa: F401  (populate registry)
    return _resolve(_MODEL_REGISTRY, model_name, "model")()


def get_loader_from_name(loader_name: str, path: str):
    """Instantiate a dataset loader by name."""
    import hypelcnn_tpu_torch.data.loaders  # noqa: F401  (populate registry)
    return _resolve(_LOADER_REGISTRY, loader_name, "loader")(path)
