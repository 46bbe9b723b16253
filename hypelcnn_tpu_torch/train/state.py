"""Training state (``hypelcnn_tpu/train/state.py``): the step count, the module
(parameters and batch-norm statistics), the optimizer with its state, and the
learning-rate schedule, which is a function of the step count."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

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

    def checkpoint(self) -> Dict[str, Any]:
        """What a checkpoint holds, on the CPU: the step, the module's
        ``state_dict`` and the optimizer's state. The step is also the
        schedule's position."""
        return {"step": self.step,
                "state_dict": _to_cpu(self.module.state_dict()),
                "optimizer": _to_cpu(self.optimizer.state_dict())}

    def restore(self, checkpoint: Dict[str, Any]) -> None:
        """Load a :meth:`checkpoint` dict; tensors go to the module's device."""
        self.module.load_state_dict(checkpoint["state_dict"], strict=True)
        self.optimizer.load_state_dict(checkpoint["optimizer"])
        self.step = int(checkpoint["step"])
