"""Training state (``hypelcnn_tpu/train/state.py``): the step count, the module
(parameters and batch-norm statistics), the optimizer with its state, and the
learning-rate schedule, which is a function of the step count.

Under tensor parallelism the parameters named in ``sharded`` hold this model
rank's slice of their output channels, and so do their optimizer moments. A
checkpoint holds full tensors all the same: :meth:`TrainState.checkpoint`
gathers the shards over the model axis (every rank calls it) and
:meth:`TrainState.restore` cuts this rank's slice of each, so a checkpoint
moves between any mesh and one rank. :meth:`TrainState.checkpoint_tree`
is the JAX package's ``TrainState`` tree of the same, which the port saves
as orbax; a checkpoint read from orbax (the JAX package's or the port's, at
full width too) has its optax state converted here, first, by the weight
bridge."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Optional

import torch

from hypelcnn_tpu_torch.compat.flax_to_torch import (
    ORBAX_TREE,
    optimizer_state_dict,
    train_state_tree,
)
from hypelcnn_tpu_torch.parallel.mesh import Mesh
from hypelcnn_tpu_torch.train.optimizer import Schedule


def _to_cpu(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, dict):
        return {k: _to_cpu(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v) for v in value)
    return value


@dataclass
class TrainState:
    step: int
    module: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    mesh: Optional[Mesh] = None
    sharded: FrozenSet[str] = frozenset()  # parameters sliced over the mesh's model axis

    def learning_rate(self) -> float:
        """The rate of the next update: the schedule at the count before it."""
        return self.schedule(self.step)

    def apply_gradients(self) -> None:
        """One optimizer update with the scheduled rate, then ``step += 1``."""
        lr = self.learning_rate()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1

    def _per_shard(self, state_dict: Dict[str, Any], optimizer: Dict[str, Any],
                   fn: Callable[[torch.Tensor], torch.Tensor]):
        """``fn`` applied to each sharded parameter and to its optimizer
        moments (the per-parameter tensors of one or more dims)."""
        names = [name for name, _ in self.module.named_parameters()]
        state_dict = {k: fn(v) if k in self.sharded else v for k, v in state_dict.items()}
        moments = {index: {k: fn(v) if names[index] in self.sharded
                           and isinstance(v, torch.Tensor) and v.dim() else v
                           for k, v in entry.items()}
                   for index, entry in optimizer["state"].items()}
        return state_dict, {**optimizer, "state": moments}

    def parameters(self) -> Dict[str, torch.Tensor]:
        """Every parameter at full width (sharded ones gathered: every rank calls this)."""
        return {name: self.mesh.gather_shards(p.detach()) if name in self.sharded else p.detach()
                for name, p in self.module.named_parameters()}

    def checkpoint(self) -> Dict[str, Any]:
        """What a checkpoint holds, on the CPU, at full width: the step, the
        module's ``state_dict`` and the optimizer's state. The step is also
        the schedule's position."""
        state_dict, optimizer = self.module.state_dict(), self.optimizer.state_dict()
        if self.sharded:
            state_dict, optimizer = self._per_shard(state_dict, optimizer,
                                                    self.mesh.gather_shards)
        return {"step": self.step, "state_dict": _to_cpu(state_dict),
                "optimizer": _to_cpu(optimizer)}

    def checkpoint_tree(self) -> Dict[str, Any]:
        """:meth:`checkpoint` as the JAX package's ``TrainState`` tree, what
        ``save_checkpoint`` writes (every rank calls this under tensor
        parallelism)."""
        return train_state_tree(self.checkpoint(), self.module, self.optimizer)

    def restore(self, checkpoint: Dict[str, Any]) -> None:
        """Load a :meth:`checkpoint` dict, or one of the JAX package's
        (``restore_checkpoint`` of an orbax step); tensors go to the module's device."""
        state_dict = checkpoint["state_dict"]
        if ORBAX_TREE in checkpoint:
            optimizer = optimizer_state_dict(checkpoint[ORBAX_TREE], self.module, self.optimizer)
        else:
            optimizer = checkpoint["optimizer"]
        if self.sharded:
            state_dict, optimizer = self._per_shard(state_dict, optimizer,
                                                    lambda t: self.mesh.shard(t).clone())
        self.module.load_state_dict(state_dict, strict=True)
        self.optimizer.load_state_dict(optimizer)
        self.step = int(checkpoint["step"])
