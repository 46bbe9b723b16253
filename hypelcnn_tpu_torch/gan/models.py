"""Shadow-translation GAN networks (``hypelcnn_tpu/gan/models.py``): 1-D
spectral convolutions and dense layers on single pixels.

Inputs are ``[B, 1, 1, bands]`` pixels (any ``[B, ..., bands]`` batch whose
trailing dims hold ``bands`` values flattens to ``[B, bands]``). Submodules
keep the flax names (``net1`` .. ``net7``, ``fc1`` .. ``fc3``,
``p{i}_fc1`` .. ``p{i}_fc4``, ``conv``, ``Conv_0``), so the weight bridge
maps a JAX-package checkpoint by name. Kept as in the JAX package:

- :func:`tf_leaky_relu` is ``where(x > 0, x, alpha * x)``: its gradient at
  exactly 0 is alpha. The generator starts at zero, so every hidden
  pre-activation is 0 on the first step and the convention decides the
  whole first update (the classifier's ``ops.nn.leaky_relu`` has gradient 1
  there and is not this function). ``torch.nn.functional.leaky_relu``
  computes exactly this, forward and backward, in one kernel each.
- SAME padding on an even kernel pads ``(k - 1) // 2`` low and ``k // 2``
  high, as XLA does; at 144 bands every generator kernel is even.
- The feature discriminator scales each patch embedding by the norm of the
  whole ``[B, E]`` tensor, not per row (``tf.math.l2_normalize`` with no axis).
- Initialization: generator kernels and biases zero; dense layers and the
  simple discriminator's conv ``he_truncated``; the simple generator's conv
  flax's default ``lecun_normal``; biases zero.

A GAN step is bound by the host's kernel launches, so each layer is written
with few: the SAME convolution lets cuDNN pad and drops the extra output of
an even kernel by slicing, and the feature discriminator runs its patches'
dense layers as one batched product a layer.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from hypelcnn_tpu_torch.models.layers import _TRUNCATED_STDDEV, he_truncated_


def tf_leaky_relu(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Leaky ReLU with TF's subgradient at 0 (alpha): torch's backward is
    ``x > 0 ? g : alpha * g``."""
    return F.leaky_relu(x, alpha)


def lecun_truncated_(weight: torch.Tensor, generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """flax's default kernel init, ``lecun_normal``: truncated normal, fan-in, scale 1."""
    fan_in = math.prod(weight.shape[1:])
    std = math.sqrt(1.0 / fan_in) / _TRUNCATED_STDDEV
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _pixels(x: torch.Tensor) -> torch.Tensor:
    """``[B, bands]`` -> ``[B, 1, 1, bands]``."""
    return x.reshape(x.shape[0], 1, 1, -1)


class SameConv1d(nn.Conv1d):
    """One-channel 1-D convolution along the bands with XLA's SAME padding.

    The weight is ``[1, 1, k]`` (flax's ``[k, 1, 1]`` kernel), the bias
    ``[1]``; both start at zero, as the generator's do. ``toeplitz`` computes
    the same function as ``x @ T`` with the banded matrix ``T`` built from
    the weight (the JAX package's opt-in ``impl="toeplitz"``).
    """

    def __init__(self, kernel_size: int, length: int, toeplitz: bool = False):
        super().__init__(1, 1, kernel_size)
        self.pad = ((kernel_size - 1) // 2, kernel_size // 2)
        self.toeplitz = toeplitz
        if toeplitz:
            # T[i, j] = w[i - j + pad_low] where that index lies in [0, k)
            i = torch.arange(length)[:, None]
            j = torch.arange(length)[None, :]
            idx = i - j + self.pad[0]
            self.register_buffer("taps", idx.clamp(0, kernel_size - 1), persistent=False)
            self.register_buffer("band", (idx >= 0) & (idx < kernel_size), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``[B, bands]`` -> ``[B, bands]``."""
        if self.toeplitz:
            w = self.weight.reshape(-1)
            matrix = torch.where(self.band, w[self.taps], torch.zeros((), dtype=w.dtype,
                                                                       device=w.device))
            return x @ matrix + self.bias[0]
        # cuDNN pads k // 2 on each side; for an even k that is one more on
        # the left than XLA's (k - 1) // 2, so the output starts one later
        k = self.kernel_size[0]
        out = F.conv1d(x.unsqueeze(1), self.weight, self.bias, padding=k // 2)
        start = 1 - k % 2
        return out[:, 0, start:start + x.shape[1]]

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        self.weight.zero_()
        self.bias.zero_()


class _LecunSameConv1d(SameConv1d):
    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        lecun_truncated_(self.weight, generator)
        self.bias.zero_()


class _Dense(nn.Linear):
    """A dense layer with ``he_truncated`` kernels and zero biases."""

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        if self.weight.numel():  # a zero-width layer (narrow patches) has no fan-in
            he_truncated_(self.weight, generator)
        self.bias.zero_()


class ShadowGenerator(nn.Module):
    """Dense-residual spectral conv generator; ``impl`` is ``"conv"`` or
    ``"toeplitz"`` (the same parameters either way)."""

    def __init__(self, band_size: int, impl: str = "conv"):
        super().__init__()
        if impl not in ("conv", "toeplitz"):
            raise ValueError(f"impl must be 'conv' or 'toeplitz', got {impl!r}")
        self.band_size = band_size
        k = band_size
        for name, ksize in (("net1", k), ("net2", k // 2), ("net3", k // 4), ("net4", k // 8),
                            ("net5", k // 4), ("net6", k // 2), ("net7", k)):
            self.add_module(name, SameConv1d(max(ksize, 1), band_size, impl == "toeplitz"))

    def forward(self, x: torch.Tensor, encoder_only: bool = False) -> torch.Tensor:
        def act(v):
            return tf_leaky_relu(v, 0.1)

        net0 = _flat(x)
        net1 = act(self.net1(net0)) + net0
        net2 = act(self.net2(net1)) + net1 + net0
        net3 = act(self.net3(net2)) + net2 + net1
        net4 = act(self.net4(net3)) + net3 + net2
        if encoder_only:
            return _pixels(net4)
        net5 = act(self.net5(net4)) + net4 + net3
        net6 = act(self.net6(net5)) + net5 + net4
        return _pixels(torch.tanh(self.net7(net6)))


class ShadowGeneratorSimple(nn.Module):
    """Single linear spectral conv."""

    def __init__(self, band_size: int):
        super().__init__()
        self.conv = _LecunSameConv1d(band_size, band_size)

    def forward(self, x: torch.Tensor, encoder_only: bool = False) -> torch.Tensor:
        return _pixels(self.conv(_flat(x)))


class ShadowDiscriminator(nn.Module):
    """3-layer dense discriminator, ``bands -> bands -> bands // 2``; like the
    JAX package's, it accepts ``generator_input`` and does not use it."""

    def __init__(self, band_size: int):
        super().__init__()
        self.fc1 = _Dense(band_size, band_size)
        self.fc2 = _Dense(band_size, band_size)
        self.fc3 = _Dense(band_size, band_size // 2)

    def forward(self, generated_data: torch.Tensor,
                generator_input: Optional[torch.Tensor] = None) -> torch.Tensor:
        net = tf_leaky_relu(self.fc1(_flat(generated_data)), 0.1)
        net = tf_leaky_relu(self.fc2(net), 0.1)
        return _pixels(self.fc3(net))


class ShadowDiscriminatorSimple(nn.Module):
    """One VALID conv over the generated pixel and the generator's input,
    concatenated."""

    def __init__(self, band_size: int):
        super().__init__()
        size = band_size * 2
        self.Conv_0 = nn.Conv1d(1, size, size)

    def forward(self, generated_data: torch.Tensor,
                generator_input: torch.Tensor) -> torch.Tensor:
        net = torch.cat([_flat(generated_data), _flat(generator_input)], dim=1).unsqueeze(1)
        return _pixels(self.Conv_0(net))

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        he_truncated_(self.Conv_0.weight, generator)
        self.Conv_0.bias.zero_()


class ShadowFeatureDiscriminator(nn.Module):
    """Per-spectral-patch dense stacks projecting to an embedding:
    ``[B, bands]`` features -> ``[B, patches, embedded_feature_size]``.

    Each patch's embeddings are divided by the L2 norm of the whole
    ``[B, E]``; on a mesh of several ranks, of the global batch's (the sum
    of squares is all-reduced).

    The patches are ``band_size // patch_count`` bands wide, from band 0 on;
    where that does not divide the bands, the last patch is narrower and
    there are more patches than ``patch_count``, as in the JAX package.
    """

    mesh = None

    def __init__(self, band_size: int, patch_count: int, embedded_feature_size: int):
        super().__init__()
        self.patch_size = band_size // patch_count
        self.starts = list(range(0, band_size, self.patch_size))
        p = self.patch_size
        for i, start in enumerate(self.starts):
            width = min(p, band_size - start)
            self.add_module(f"p{i}_fc1", _Dense(width, p))
            self.add_module(f"p{i}_fc2", _Dense(p, p // 4))
            self.add_module(f"p{i}_fc3", _Dense(p // 4, p // 2))
            self.add_module(f"p{i}_fc4", _Dense(p // 2, embedded_feature_size))

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        net = _flat(features)
        n, p = len(self.starts), self.patch_size
        # [patches, B, p]; a narrow last patch is zero-filled, and so are the
        # missing columns of its first kernel, which adds exact zeros
        cur = F.pad(net, (0, n * p - net.shape[1])).view(-1, n, p).transpose(0, 1)
        for layer in range(1, 5):
            dense = [getattr(self, f"p{i}_fc{layer}") for i in range(n)]
            weights = torch.stack([F.pad(d.weight, (0, p - d.weight.shape[1]))
                                   if d.weight.shape[1] < p and layer == 1 else d.weight
                                   for d in dense])
            biases = torch.stack([d.bias for d in dense]).unsqueeze(1)
            cur = tf_leaky_relu(torch.baddbmm(biases, cur, weights.transpose(1, 2)), 0.1)
        # x * rsqrt(max(sum(x^2), 1e-12)) over each patch's whole [B, E]; the
        # max keeps the gradient finite at the zero vector
        squares = torch.sum(cur * cur, dim=(1, 2), keepdim=True)
        if self.mesh is not None and self.mesh.sharded:
            squares = self.mesh.all_reduce_sum(squares)
        cur = cur * torch.rsqrt(torch.clamp(squares, min=1e-12))
        return cur.transpose(0, 1)
