"""Checkpoints of a model's ``state_dict``.

The directory layout is the JAX package's orbax manager's
(``<log_dir>/checkpoints/<step>/``); each step directory holds one
``torch.save`` file of ``{"step", "state_dict"}``. The trainer slice of the
port adds ``MAX_TO_KEEP`` and auto-resume.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch

CHECKPOINT_FILE = "state.pt"


def _checkpoint_dir(log_dir: str) -> str:
    return os.path.abspath(os.path.join(log_dir, "checkpoints"))


def save_checkpoint(log_dir: str, step: int, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write ``state_dict`` (moved to the CPU) as step ``step``; returns the file path."""
    step_dir = os.path.join(_checkpoint_dir(log_dir), str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, CHECKPOINT_FILE)
    cpu_state = {key: value.detach().cpu() for key, value in state_dict.items()}
    torch.save({"step": int(step), "state_dict": cpu_state}, path)
    return path


def restore_checkpoint(log_dir: str) -> Optional[dict]:
    """The latest ``{"step", "state_dict"}`` under ``log_dir``, or None when there is none."""
    root = _checkpoint_dir(log_dir)
    if not os.path.isdir(root):
        return None
    steps = [int(name) for name in os.listdir(root)
             if name.isdigit() and os.path.isfile(os.path.join(root, name, CHECKPOINT_FILE))]
    if not steps:
        return None
    path = os.path.join(root, str(max(steps)), CHECKPOINT_FILE)
    return torch.load(path, map_location="cpu", weights_only=True)
