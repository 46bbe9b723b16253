"""Layers with tf-slim semantics (``hypelcnn_tpu/models/layers.py``).

tf-slim composes linear (bias only when unnormalized) -> optional batch norm
-> activation, and its batch norm has a bias and no scale, with eps 1e-3.
Submodules keep the flax names (``Conv_0``, ``Dense_0``, ``BatchNorm_0``), so
a flax variable path maps to a ``state_dict`` key by name
(:mod:`hypelcnn_tpu_torch.compat.flax_to_torch`). Tensors are NCHW inside the
models (channels on dim 1) and ``[B, features]`` for the dense layers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

# the JAX package's he_truncated: variance_scaling(2.0, "fan_in",
# "truncated_normal"); the stddev of a unit normal truncated to [-2, 2]
_TRUNCATED_STDDEV = 0.87962566103423978


class SlimBatchNorm(nn.Module):
    """Batch norm with a bias and no scale.

    Evaluation normalizes with the running statistics:
    ``(x - mean) * rsqrt(var + eps) + bias``. Training normalizes with the
    biased batch variance and folds the Bessel-corrected one into the
    running variance, as TF's fused batch norm and the JAX package do.
    """

    def __init__(self, features: int, momentum: float = 0.95, epsilon: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = [0, *range(2, x.dim())]
            mean = x.mean(dims)
            var = (x * x).mean(dims) - mean * mean
            with torch.no_grad():
                n = x.numel() // x.shape[1]
                bessel = n / max(n - 1, 1)
                m = self.momentum
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var * bessel)
        else:
            mean, var = self.mean, self.var
        return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + self.epsilon) \
            + self.bias.view(shape)


class SlimConv(nn.Module):
    """conv (SAME padding, odd kernel) -> [batch norm] -> activation."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 activation: Optional[Callable] = torch.relu, use_batch_norm: bool = False,
                 bn_momentum: float = 0.95):
        super().__init__()
        if kernel % 2 != 1:
            raise ValueError(f"SAME padding is symmetric only for odd kernels, got {kernel}")
        self.Conv_0 = nn.Conv2d(in_features, features, kernel, padding=kernel // 2,
                                bias=not use_batch_norm)
        self.BatchNorm_0 = SlimBatchNorm(features, bn_momentum) if use_batch_norm else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


class SlimDense(nn.Module):
    """dense -> [batch norm] -> activation."""

    def __init__(self, in_features: int, features: int,
                 activation: Optional[Callable] = torch.relu, use_batch_norm: bool = False,
                 bn_momentum: float = 0.95):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features, bias=not use_batch_norm)
        self.BatchNorm_0 = SlimBatchNorm(features, bn_momentum) if use_batch_norm else None
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Dense_0(x)
        if self.BatchNorm_0 is not None:
            x = self.BatchNorm_0(x)
        if self.activation is not None:
            x = self.activation(x)
        return x


def multi_scale_level(x: torch.Tensor, convs: Sequence[nn.Module]) -> torch.Tensor:
    """Parallel SAME convolutions, one per odd kernel size, concatenated on channels."""
    return torch.cat([conv(x) for conv in convs], dim=1)


def he_truncated_(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Truncated-normal fan-in init with scale 2 (the JAX package's ``he_truncated``)."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(2.0 / fan_in) / _TRUNCATED_STDDEV
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


@torch.no_grad()
def init_parameters(module: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Initialize every slim layer under ``module`` as the JAX package does:
    He-truncated kernels, zero biases, running mean 0 and variance 1."""
    for layer in module.modules():
        if isinstance(layer, (SlimConv, SlimDense)):
            linear = layer.Conv_0 if isinstance(layer, SlimConv) else layer.Dense_0
            he_truncated_(linear.weight, generator)
            if linear.bias is not None:
                linear.bias.zero_()
        elif isinstance(layer, SlimBatchNorm):
            layer.bias.zero_()
            layer.mean.zero_()
            layer.var.fill_(1.0)
