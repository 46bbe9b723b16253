"""Model-plugin protocol (``hypelcnn_tpu/models/base.py``).

:meth:`NNModel.create_module` returns an ``nn.Module`` whose forward takes
NHWC patches ``[B, k, k, C]`` and returns a :class:`ModelOutput`. Unlike flax,
PyTorch needs each layer's input width when the layer is built, so the
module is built for one ``data_shape`` ``[k, k, C]``. :meth:`NNModel.loss`
maps (output, one-hot labels) to a per-example loss vector, which the
trainer averages over the batch.
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

    @abstractmethod
    def loss(self, output: ModelOutput, labels_onehot: torch.Tensor) -> torch.Tensor:
        """Per-example loss vector ``[B]`` (mean-reduced by the trainer)."""
        ...

    def default_params(self) -> Dict[str, Any]:
        return {}


def softmax_cross_entropy(logits: torch.Tensor, labels_onehot: torch.Tensor) -> torch.Tensor:
    return -(labels_onehot * torch.log_softmax(logits, dim=-1)).sum(dim=-1)


def reconstruction_loss(output: ModelOutput) -> torch.Tensor:
    """Scalar MSE between the reconstruction head and the flattened NHWC input."""
    original = output.image_original.reshape(output.image_original.shape[0], -1)
    return torch.mean(torch.square(output.image_output - original))
