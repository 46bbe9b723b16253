"""Model-plugin protocol (``hypelcnn_tpu/models/base.py``).

:meth:`NNModel.create_module` returns an ``nn.Module`` whose forward takes
NHWC patches ``[B, k, k, C]`` and returns a :class:`ModelOutput`. Unlike flax,
PyTorch needs each layer's input width when the layer is built, so the
module is built for one ``data_shape`` ``[k, k, C]``. The losses come with
the training slice of the port.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch


class ModelOutput(NamedTuple):
    y_conv: torch.Tensor                    # logits [B, classes]
    image_output: Optional[torch.Tensor]    # reconstruction head (train only)
    image_original: Optional[torch.Tensor]  # the model's NHWC input
    histograms: Dict[str, torch.Tensor]     # activation-analysis taps


class NNModel(ABC):
    """A model family plugin."""

    @abstractmethod
    def create_module(self, class_count: int, algorithm_params: Dict[str, Any],
                      data_shape: Sequence[int]) -> torch.nn.Module:
        ...

    def default_params(self) -> Dict[str, Any]:
        return {}
