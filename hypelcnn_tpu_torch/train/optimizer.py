"""Optimizer and learning-rate schedule from ``algorithm_params``
(``hypelcnn_tpu/train/optimizer.py``).

- The schedule is a staircase exponential decay,
  ``lr = learning_rate * decay_factor ** floor(count / decay_step)``. As in
  optax, the update that takes the step count from ``count`` to ``count + 1``
  uses ``schedule(count)``: the first update uses exponent 0.
- ``"AdamOptimizer"`` is ``torch.optim.Adam`` with b1 0.9, b2 0.999, eps 1e-8
  (eps added to the bias-corrected ``sqrt(v)``, as optax does).
- ``["MomentumOptimizer", m]`` is ``torch.optim.SGD`` with momentum ``m``, no
  dampening and no Nesterov: the first update moves by ``lr * g``, as optax's
  trace does from a zero start.

The caller sets each update's learning rate from the schedule
(:meth:`hypelcnn_tpu_torch.train.state.TrainState.apply_gradients`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, Tuple

import torch

Schedule = Callable[[int], float]


def build_schedule(algorithm_params: Dict[str, Any]) -> Schedule:
    init_value = float(algorithm_params["learning_rate"])
    transition_steps = algorithm_params["learning_rate_decay_step"]
    decay_rate = float(algorithm_params["learning_rate_decay_factor"])

    def schedule(count: int) -> float:
        if count <= 0:
            return init_value
        return init_value * decay_rate ** math.floor(count / transition_steps)

    return schedule


def build_optimizer(algorithm_params: Dict[str, Any], parameters: Iterable[torch.nn.Parameter]
                    ) -> Tuple[torch.optim.Optimizer, Schedule]:
    schedule = build_schedule(algorithm_params)
    spec = algorithm_params.get("optimizer", "AdamOptimizer")
    if isinstance(spec, (tuple, list)):
        if spec[0] != "MomentumOptimizer":
            raise ValueError(f"unknown optimizer spec {spec!r}")
        optimizer = torch.optim.SGD(parameters, lr=schedule(0), momentum=float(spec[1]))
    elif spec == "AdamOptimizer":
        optimizer = torch.optim.Adam(parameters, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)
    else:
        raise ValueError(f"unknown optimizer spec {spec!r}")
    return optimizer, schedule
