"""Checkpoints of the training state, written as the JAX package writes them.

The directory layout is the JAX package's orbax manager's
(``<log_dir>/checkpoints/<step>/``): :func:`save_checkpoint` writes a step
as an orbax checkpoint whose one item is ``default/``, from the tree of a
JAX ``TrainState`` or ``GANState``
(:func:`~hypelcnn_tpu_torch.compat.flax_to_torch.train_state_tree`,
:func:`~hypelcnn_tpu_torch.compat.flax_to_torch.gan_state_tree`), so the
JAX package's ``restore_checkpoint`` reads it with its own template. A step
is written once: writing into one that exists raises, as orbax's manager
refuses it. At most ``MAX_TO_KEEP`` steps are kept, the oldest pruned
first.

A params-only snapshot (a trained GAN's networks, for translation or as a
frozen shadow augmenter) is a ``StandardCheckpointer`` directory at the JAX
package's paths (``<log_dir>/ckpt_params_N``, ``<log_dir>/gan_params``):
:func:`save_params` writes the flax params tree of a ``state_dict``, host
arrays as the JAX package's ``jax.device_get`` gives them, and replaces a
snapshot that is there (the JAX package's ``force=True``). Loaders declare
those paths, and they are found with ``os.path.isdir``.

Both readers read either kind the JAX package or the port wrote, and the
``torch.save`` files the port wrote before it wrote orbax (a step
directory's ``state.pt`` of ``{"step", "state_dict"}``, plus ``"optimizer"``
or a GAN's whole state; a snapshot's ``params.pt``), so older log dirs
still resume. :func:`restore_checkpoint` gives the same dict for either
kind (``step`` and ``state_dict``; an orbax one also keeps its tree, from
which the training states convert their optimizers); :func:`restore_params`
the same ``state_dict``. So a log dir moves both ways between the JAX
package and the port.

:func:`checkpoint_steps` lists the step directories of both kinds, and
pruning to ``MAX_TO_KEEP`` counts them together, oldest first. A step being
written lives in a temporary sibling directory until it is whole, and
:func:`checkpoint_steps` counts digit names only, so a write that dies
leaves the steps as they were.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Mapping, Optional

import torch

from hypelcnn_tpu_torch.compat.flax_to_torch import (
    orbax_payload,
    snapshot_tree,
    variables_to_state_dict,
)
from hypelcnn_tpu_torch.compat.orbax import is_orbax_checkpoint, read_orbax, write_orbax

CHECKPOINT_FILE = "state.pt"  # the port's step file before it wrote orbax
PARAMS_FILE = "params.pt"  # the port's snapshot file before it wrote orbax
ITEM = "default"
MAX_TO_KEEP = 20


def _checkpoint_dir(log_dir: str) -> str:
    return os.path.abspath(os.path.join(log_dir, "checkpoints"))


def _step_dir(log_dir: str, step: int) -> str:
    return os.path.join(_checkpoint_dir(log_dir), str(int(step)))


def checkpoint_steps(log_dir: str) -> List[int]:
    """The saved steps under ``log_dir``, orbax and ``state.pt`` ones, oldest first."""
    root = _checkpoint_dir(log_dir)
    if not os.path.isdir(root):
        return []
    return sorted(int(name) for name in os.listdir(root)
                  if name.isdigit() and (os.path.isfile(os.path.join(root, name, CHECKPOINT_FILE))
                                         or is_orbax_checkpoint(os.path.join(root, name))))


def holds_orbax_step(log_dir: str, step: int) -> bool:
    """Whether step ``step`` under ``log_dir`` is an orbax checkpoint."""
    return is_orbax_checkpoint(_step_dir(log_dir, step))


def save_checkpoint(log_dir: str, tree: Mapping[str, Any],
                    max_to_keep: int = MAX_TO_KEEP) -> str:
    """Write the state ``tree`` (its ``step`` names the step) as an orbax
    step, prune all but the newest ``max_to_keep`` steps; returns the step
    directory. A step that exists raises ``FileExistsError``."""
    step_dir = write_orbax(_step_dir(log_dir, int(tree["step"])), tree, item=ITEM)
    for old in checkpoint_steps(log_dir)[:-max_to_keep]:
        shutil.rmtree(_step_dir(log_dir, old))
    return step_dir


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


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> str:
    """Write the flax params of ``state_dict`` as the orbax snapshot
    directory ``path``, replacing one that is there; returns ``path``."""
    return write_orbax(path, snapshot_tree(state_dict), replace=True)


def restore_params(path: str) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of the snapshot directory ``path`` (orbax or ``params.pt``)."""
    if is_orbax_checkpoint(path):
        return variables_to_state_dict(read_orbax(path))
    return torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True)
