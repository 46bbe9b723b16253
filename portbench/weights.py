"""A model's weights made on the card from the seed, by the reference
model's list of tensors, in float32 (the type they are served in).

Each initializer draws its share of all the model's kernels in one call
(a truncated normal by the inverse of its distribution function over one
uniform draw; Glorot's uniform over another), then each kernel takes its
own scale: He's ``sqrt(2 / fan_in)`` over the deviation of a unit normal
truncated to [-2, 2], or Glorot's ``sqrt(6 / (fan_in + fan_out))``.
Biases are 0, batch norm's running means 0 and variances 1.

For a sweep a classifier needs weights whose classes each win somewhere
(with running means 0 and variances 1, or with every bias 0, nearly every
pixel falls into one class): :func:`calibrate` sets each batch norm's
running statistics to the moments of a batch of the scene's windows, one
layer after another, draws every batch norm's bias from N(0, 0.1^2), and
then moves the logit layer's bias (``model.output_bias``) by minus the
batch's mean logits.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from portbench.reference.common import Norms

_TRUNCATED_STDDEV = 0.87962566103423978  # of a unit normal cut to [-2, 2]


def _fans(shape) -> tuple:
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def make_weights(model, generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    spec = model.params()
    weights: Dict[str, torch.Tensor] = {}
    for init in ("he_truncated", "xavier"):
        leaves = [p for p in spec if p.init == init]
        total = sum(math.prod(p.shape) for p in leaves)
        if not total:
            continue
        u = torch.rand(total, generator=generator, device=device, dtype=torch.float64)
        if init == "he_truncated":
            lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, (1 + math.erf(2 / math.sqrt(2))) / 2
            draws = (math.sqrt(2) * torch.erfinv(2 * (lo + u * (hi - lo)) - 1)).to(torch.float32)
        else:
            draws = (2 * u - 1).to(torch.float32)
        start = 0
        for p in leaves:
            size = math.prod(p.shape)
            fan_in, fan_out = _fans(p.shape)
            scale = math.sqrt(2.0 / fan_in) / _TRUNCATED_STDDEV if init == "he_truncated" \
                else math.sqrt(6.0 / (fan_in + fan_out))
            weights[p.name] = draws[start:start + size].view(p.shape) * scale
            start += size
    for p in spec:
        if p.init in ("zeros", "ones"):
            weights[p.name] = torch.full(p.shape, 1.0 if p.init == "ones" else 0.0,
                                         device=device, dtype=torch.float32)
    return weights


@torch.no_grad()
def calibrate(model, weights: Dict[str, torch.Tensor], batch: torch.Tensor,
              generator: torch.Generator) -> None:
    """Running statistics from ``batch``'s moments, random batch-norm
    biases, then centred logits; in place."""
    biases = [name for name in weights if name.endswith("BatchNorm_0.bias")]
    if biases:
        moments: Dict[str, torch.Tensor] = {}
        model.forward(weights, batch, Norms("batch", record=moments))
        for name, value in moments.items():
            weights[name].copy_(value)
        sizes = [weights[name].numel() for name in biases]
        draws = 0.1 * torch.randn(sum(sizes), generator=generator, device=batch.device)
        for name, part in zip(biases, torch.split(draws, sizes)):
            weights[name].copy_(part)
    logits, _ = model.forward(weights, batch, Norms("running"))
    weights[model.output_bias].sub_(logits.mean(dim=0))
