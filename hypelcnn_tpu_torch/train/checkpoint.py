"""Checkpoints of the training state.

The directory layout is the JAX package's orbax manager's
(``<log_dir>/checkpoints/<step>/``); each step directory holds one
``torch.save`` file of ``{"step", "state_dict"}``, plus ``"optimizer"``
when the trainer saved it. At most ``MAX_TO_KEEP``
steps are kept, the oldest pruned first. Everything is saved from the CPU
and loads under ``weights_only=True``. A GAN run saves its whole state
there too (networks, every optimizer's count and moments, the pools).

A params-only snapshot (a trained GAN's networks, for translation or as a
frozen shadow augmenter) is a directory holding one ``params.pt``, at the
JAX package's paths (``<log_dir>/ckpt_params_N``, ``<log_dir>/gan_params``):
loaders declare those paths, and they are found with ``os.path.isdir``.

Both readers also read what the JAX package writes at those paths, orbax
checkpoints (:mod:`hypelcnn_tpu_torch.compat.orbax`): a step directory or a
snapshot directory holding ``_CHECKPOINT_METADATA`` and none of the port's
files. :func:`restore_checkpoint` gives the same dict for either kind
(``step`` and ``state_dict``; an orbax one also keeps its tree, from which
the training states convert their optimizers); :func:`restore_params` the
same ``state_dict``. So a JAX log dir resumes, classifies and augments in
the port. The port writes only its own files: :func:`save_checkpoint`
refuses a step directory that holds an orbax checkpoint, and
:func:`save_params` replaces an orbax snapshot as it replaces its own.

:func:`checkpoint_steps` lists the step directories of both kinds, and
pruning to ``MAX_TO_KEEP`` counts them together, oldest first: a run that
resumed from the JAX package's steps removes the oldest of them as it saves
newer ones, as the JAX package's own manager would.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from hypelcnn_tpu_torch.compat.flax_to_torch import orbax_payload, variables_to_state_dict
from hypelcnn_tpu_torch.compat.orbax import is_orbax_checkpoint, read_orbax

CHECKPOINT_FILE = "state.pt"
PARAMS_FILE = "params.pt"
MAX_TO_KEEP = 20


def _checkpoint_dir(log_dir: str) -> str:
    return os.path.abspath(os.path.join(log_dir, "checkpoints"))


def _step_dir(log_dir: str, step: int) -> str:
    return os.path.join(_checkpoint_dir(log_dir), str(int(step)))


def checkpoint_steps(log_dir: str) -> List[int]:
    """The saved steps under ``log_dir``, the port's and orbax ones, oldest first."""
    root = _checkpoint_dir(log_dir)
    if not os.path.isdir(root):
        return []
    return sorted(int(name) for name in os.listdir(root)
                  if name.isdigit() and (os.path.isfile(os.path.join(root, name, CHECKPOINT_FILE))
                                         or is_orbax_checkpoint(os.path.join(root, name))))


def holds_orbax_step(log_dir: str, step: int) -> bool:
    """Whether step ``step`` under ``log_dir`` is an orbax checkpoint."""
    return is_orbax_checkpoint(_step_dir(log_dir, step))


def save_checkpoint(log_dir: str, step: int, state_dict: Dict[str, torch.Tensor],
                    max_to_keep: int = MAX_TO_KEEP, **extra: Any) -> str:
    """Write ``state_dict`` (moved to the CPU) and ``extra`` entries as step
    ``step``, prune all but the newest ``max_to_keep`` steps; returns the file path."""
    root = _checkpoint_dir(log_dir)
    step_dir = _step_dir(log_dir, step)
    if is_orbax_checkpoint(step_dir):
        raise FileExistsError(f"{step_dir} holds an orbax checkpoint of the JAX package; "
                              "the port does not write into it")
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, CHECKPOINT_FILE)
    cpu_state = {key: value.detach().cpu() for key, value in state_dict.items()}
    torch.save({**extra, "step": int(step), "state_dict": cpu_state}, path)
    for old in checkpoint_steps(log_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(root, str(old)))
    return path


def restore_checkpoint(log_dir: str) -> Optional[dict]:
    """The latest checkpoint dict under ``log_dir``, or None when there is none."""
    steps = checkpoint_steps(log_dir)
    if not steps:
        return None
    step_dir = _step_dir(log_dir, steps[-1])
    if is_orbax_checkpoint(step_dir):
        return orbax_payload(read_orbax(step_dir))
    return torch.load(os.path.join(step_dir, CHECKPOINT_FILE), map_location="cpu",
                      weights_only=True)


def save_params(path: str, state_dict: Dict[str, torch.Tensor]) -> str:
    """Write ``state_dict`` (moved to the CPU) as the snapshot directory
    ``path``, replacing one that is there; returns the file path."""
    if is_orbax_checkpoint(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)
    file_path = os.path.join(path, PARAMS_FILE)
    torch.save({key: value.detach().cpu() for key, value in state_dict.items()}, file_path)
    return file_path


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the snapshot directory ``path`` (the port's or orbax)."""
    if is_orbax_checkpoint(path):
        return variables_to_state_dict(read_orbax(path))
    return torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True)
