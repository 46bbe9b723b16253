"""GAN losses (``hypelcnn_tpu/gan/losses.py``).

Least-squares and Wasserstein adversarial pairs, the cycle-consistency and
identity L1 terms, CUT's patchwise NCE loss and the discriminators' l2
regularization. :class:`TFSoftmaxCrossEntropy` keeps TF's fused backward,
``g * (softmax - labels)``, which is not the derivative of the loss it
returns when the label rows sum to more than 1 (NCE's flattened identity
labels sum to the patch count); it passes no gradient to the labels.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch import nn


def least_squares_generator_loss(disc_gen_outputs: torch.Tensor,
                                 real_label: float = 1.0) -> torch.Tensor:
    return 0.5 * torch.mean(torch.square(disc_gen_outputs - real_label))


def least_squares_discriminator_loss(disc_real_outputs: torch.Tensor,
                                     disc_gen_outputs: torch.Tensor,
                                     real_label: float = 1.0,
                                     fake_label: float = 0.0) -> torch.Tensor:
    loss_real = torch.mean(torch.square(disc_real_outputs - real_label))
    loss_gen = torch.mean(torch.square(disc_gen_outputs - fake_label))
    return 0.5 * (loss_real + loss_gen)


def wasserstein_generator_loss(disc_gen_outputs: torch.Tensor) -> torch.Tensor:
    return -torch.mean(disc_gen_outputs)


def wasserstein_discriminator_loss(disc_real_outputs: torch.Tensor,
                                   disc_gen_outputs: torch.Tensor) -> torch.Tensor:
    return torch.mean(disc_gen_outputs) - torch.mean(disc_real_outputs)


def cycle_consistency_loss(x: torch.Tensor, reconstructed_x: torch.Tensor,
                           y: torch.Tensor, reconstructed_y: torch.Tensor) -> torch.Tensor:
    """mean |F(G(x)) - x| + mean |G(F(y)) - y|."""
    return (torch.mean(torch.abs(reconstructed_x - x))
            + torch.mean(torch.abs(reconstructed_y - y)))


def identity_loss(inputs: torch.Tensor, identity_mapped: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(identity_mapped - inputs))


class TFSoftmaxCrossEntropy(torch.autograd.Function):
    """Per-row softmax cross-entropy ``-(labels * log_softmax(logits)).sum(-1)``
    with TF's fused-op backward."""

    @staticmethod
    def forward(ctx, flat_logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(flat_logits, labels)
        return -(labels * torch.log_softmax(flat_logits, dim=-1)).sum(dim=-1)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        flat_logits, labels = ctx.saved_tensors
        return g.unsqueeze(-1) * (torch.softmax(flat_logits, dim=-1) - labels), None


def nce_loss(query_feats: torch.Tensor, key_feats: torch.Tensor, tau: float) -> torch.Tensor:
    """Patchwise NCE on ``[B, P, E]`` embeddings: the ``[P, P]``
    cross-similarities over ``tau`` and identity labels, both flattened to
    ``P * P`` (softmax over all of them), averaged over the batch."""
    logits = torch.einsum("bpe,bqe->bpq", query_feats, key_feats) / tau
    batch, p, q = logits.shape
    labels = torch.eye(p, q, dtype=torch.float32, device=logits.device
                       ).reshape(1, p * q).expand(batch, p * q)
    return torch.mean(TFSoftmaxCrossEntropy.apply(logits.reshape(batch, p * q), labels))


def l2_regularization(modules: Iterable[nn.Module], scale: float,
                      exclude: Tuple[str, ...] = ()) -> torch.Tensor:
    """``scale * 0.5 * sum(w^2)`` over the kernels (``weight``s; no biases) of
    ``modules``, skipping any under a submodule named in ``exclude`` (the
    discriminator's ``fc3`` is not regularized)."""
    kernels = [weight for module in modules for name, weight in module.named_parameters()
               if name.split(".")[-1] == "weight"
               and not set(name.split(".")[:-1]) & set(exclude)]
    return scale * 0.5 * sum(torch.sum(torch.square(w)) for w in kernels)
