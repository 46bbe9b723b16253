"""CAP, the capsule network with dynamic routing (``hypelcnn_tpu/models/cap.py``).

- A VALID conv stem and a VALID PrimaryCaps conv, both batch-normalized
  (momentum 0.999) with ReLU. Their batch norm uses the BATCH statistics in
  evaluation too (the reference never passes ``is_training`` to tf-slim's
  batch norm), so a window's class depends on the other windows of its
  batch; the running statistics move only in training.
- The PrimaryCaps output, in NHWC order, is ``data_size`` input capsules of
  ``pco`` values. ``pco`` is read from ``digit_capsule_output_space``, the
  reference's quirk.
- Each input capsule's linear map to the ``class_count`` digit capsules of
  ``dco`` values (``digitcaps_w [data_size, pco, class_count*dco]``, xavier
  per capsule, and ``digitcaps_b``) is one batched product over the capsule
  axis.
- ``iter_routing`` rounds of dynamic routing: softmax coupling over the
  classes, the mean-of-squares ``squash``, and agreement logits summed over
  the whole batch, shared by every window of it (on a mesh of several
  ranks, over the global batch: the agreement is all-reduced each round).
- Class scores are the digit capsules' L2 norms. In training with labels a
  decoder (512 and 1,024 leaky-ReLU units, then a sigmoid to ``k*k*C``)
  reconstructs the input from the label's capsule; the loss is cross-entropy
  plus the reconstruction MSE.

Two routes through the capsule layer, chosen by what the forward observes:

- Where autograd records (``torch.is_grad_enabled()`` and the primary
  capsules or a capsule weight require grad: every training step),
  :meth:`CAPModule.u_hat_route` materializes the prediction vectors
  ``u_hat`` as ``[data_size, classes, dco, B]``, the batched product's
  natural output, adds their bias in place, and routes over them with one
  product a weighted sum and one an agreement, each reading ``u_hat`` as a
  strided matrix of the same memory (8.4 GB at a sweep band of 30,480
  windows of 3x3). It keeps the JAX package's summation order, which CAP's
  training trajectory is held to.
- Otherwise (``inference_mode``, ``no_grad``: sweeps, drains),
  :meth:`CAPModule.folded_route` never forms ``u_hat``. The couplings are
  one ``[data_size, classes]`` table for the whole batch, so each round folds
  them into the capsule weights, and the weighted sum is one float32 GEMM of
  the primary capsules ``U [B, data_size*pco]`` against the folded weight
  ``[data_size*pco, classes*dco]``; the agreement is the GEMM ``U^T V``,
  contracted with the weights and the bias. The same sums, reassociated.

The routes share ``squash``, the spans and the counters. Spans
(``core/trace.py``; the forward's call number is their id): ``cap.transform``
around the ``u_hat`` product and its bias, or around the first round's folded
weight and weighted sum; ``cap.routing`` around the rest of the routing up to
the class norms. Counters, plain values on the class:
``CAPModule.u_hat_bytes`` (the bytes of ``u_hat`` the last forward
materialized, 0 after a folded one), ``CAPModule.routing_products`` (the
routing products the last forward launched, ``2 * iter_routing - 1`` on
either route) and ``CAPModule.routes`` (the forwards each route took since
:meth:`CAPModule.reset_routes`).
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.core.registry import register_model
from hypelcnn_tpu_torch.models.base import (
    ModelOutput,
    NNModel,
    reconstruction_loss,
    softmax_cross_entropy,
)
from hypelcnn_tpu_torch.models.layers import SlimConv, SlimDense, compute_dtype
from hypelcnn_tpu_torch.ops.nn import leaky_relu, squash

DEFAULT_PARAMS: Dict[str, Any] = {
    # matches configs/modelconfigs/alg_param_capn.json
    "iter_routing": 3,
    "conv_layer_kernel_size": 1,
    "primary_caps_kernel_size": 1,
    "feature_count": 256,
    "primary_capsule_count": 32,
    "primary_capsule_output_space": 8,
    "digit_capsule_output_space": 16,
    "batch_size": 16,
    "optimizer": "AdamOptimizer",
    "learning_rate": 1e-4,
    "learning_rate_decay_factor": 0.96,
    "learning_rate_decay_step": 350,
    "lrelu_alpha": 0.18,
    "enable_decoding": True,
    "compute_dtype": "float32",
}
_FORWARDS = itertools.count()  # a forward's call number, the id of its spans


class CAPModule(nn.Module):
    mesh = None
    u_hat_bytes = 0  # of the last forward, on every instance
    routing_products = 0
    routes = {"u_hat": 0, "folded": 0}  # forwards a route, since reset_routes

    def __init__(self, class_count: int, params_dict: Dict[str, Any], data_shape: Sequence[int]):
        super().__init__()
        p = params_dict
        compute_dtype(p)  # accepted and unused: CAP computes in float32, as in JAX
        patch, patch_w, in_channels = data_shape
        # the reference's quirk: the primary capsules' size is read from the digit key
        self.pco = p["digit_capsule_output_space"]
        self.dco = p["digit_capsule_output_space"]
        self.classes = class_count
        self.iter_routing = p["iter_routing"]
        self.enable_decoding = p["enable_decoding"]

        def conv(cin: int, features: int, kernel: int) -> SlimConv:
            return SlimConv(cin, features, kernel, padding="VALID", use_batch_norm=True,
                            bn_momentum=0.999, always_batch_stats=True)

        ck, pk = p["conv_layer_kernel_size"], p["primary_caps_kernel_size"]
        self.Conv1_layer = conv(in_channels, p["feature_count"], ck)
        primary = p["primary_capsule_count"] * self.pco
        self.PrimaryCaps_layer = conv(p["feature_count"], primary, pk)
        out_h, out_w = patch - ck - pk + 2, patch_w - ck - pk + 2
        self.data_size = out_h * out_w * primary // self.pco
        self.digitcaps_w = nn.Parameter(torch.zeros(self.data_size, self.pco,
                                                    class_count * self.dco))
        self.digitcaps_b = nn.Parameter(torch.zeros(self.data_size, class_count * self.dco))

        act = functools.partial(leaky_relu, alpha=p["lrelu_alpha"])
        self.decoder_fc1 = SlimDense(self.dco, 512, activation=act)
        self.decoder_fc2 = SlimDense(512, 1024, activation=act)
        self.decoder_fc3 = SlimDense(1024, patch * patch_w * in_channels, activation=torch.sigmoid)

    @torch.no_grad()
    def init_parameters_(self, generator: Optional[torch.Generator] = None) -> None:
        """Xavier-uniform per input capsule (fan-in ``pco``, fan-out
        ``classes*dco``; the capsule axis is a batch axis), zero biases."""
        fan_in, fan_out = self.digitcaps_w.shape[1:]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        self.digitcaps_w.uniform_(-bound, bound, generator=generator)
        self.digitcaps_b.zero_()

    @classmethod
    def reset_routes(cls) -> None:
        """Set both counts of :attr:`routes` to 0."""
        cls.routes = {"u_hat": 0, "folded": 0}

    def u_hat_route(self, u: torch.Tensor, call: int):
        """Route the primary capsules ``u [B, data_size, pco]`` over
        materialized prediction vectors. Returns the digit capsules ``v``
        ``[classes, dco, B]``, the class scores ``[B, classes]`` and the last
        round's routing logits ``[data_size, classes]``."""
        batch = u.shape[0]
        d, j, c = self.data_size, self.classes, self.dco
        with trace.span("cap.transform", call):
            # u_hat[d, q, b] = sum_p w[d, p, q] u[b, d, p] + b_lin[d, q]: one product batched
            # over d (the bias is added in place: the product's backward does not need its output)
            u_hat = torch.bmm(self.digitcaps_w.transpose(1, 2), u.permute(1, 2, 0))
            u_hat.add_(self.digitcaps_b.unsqueeze(2))
        CAPModule.u_hat_bytes = u_hat.numel() * u_hat.element_size()
        by_class = u_hat.view(d, j, c * batch).transpose(0, 1)  # [J, D, C*B], no copy

        products = 0
        with trace.span("cap.routing", call):
            b_ij = torch.zeros((d, j), dtype=u_hat.dtype, device=u_hat.device)
            v = None
            for round_ in range(self.iter_routing):
                c_ij = torch.softmax(b_ij, dim=1)
                s = torch.bmm(c_ij.t().unsqueeze(1), by_class).view(j, c, batch)
                products += 1
                v = squash(s, dim=1)
                if round_ + 1 < self.iter_routing:  # the last round's agreement is unused
                    agreement = torch.bmm(by_class, v.view(j, c * batch, 1)).squeeze(2)
                    products += 1
                    if self.mesh is not None and self.mesh.sharded:
                        agreement = self.mesh.all_reduce_sum(agreement)
                    b_ij = b_ij + agreement.t()

            y_conv = torch.linalg.vector_norm(v, dim=1).t()  # [B, J]
        CAPModule.routing_products = products
        CAPModule.routes["u_hat"] += 1
        return v, y_conv, b_ij

    def folded_route(self, u: torch.Tensor, call: int):
        """Route the primary capsules ``u [B, data_size, pco]`` with each
        round's couplings folded into the capsule weights: ``u_hat`` is never
        formed. Returns what :meth:`u_hat_route` returns."""
        batch = u.shape[0]
        d, p, j, c = self.data_size, self.pco, self.classes, self.dco
        w = self.digitcaps_w.view(d, p, j, c)
        bias = self.digitcaps_b.view(d, j, c)
        flat = u.reshape(batch, d * p)

        def weighted_sum(b_ij: torch.Tensor) -> torch.Tensor:
            # s[b, j, c] = sum_(d, p) u[b, d, p] (c_ij[d, j] w[d, p, j, c])
            #              + sum_d c_ij[d, j] b_lin[d, j, c]
            c_ij = torch.softmax(b_ij, dim=1)
            folded = (w * c_ij.view(d, 1, j, 1)).view(d * p, j * c)
            shift = (c_ij.unsqueeze(2) * bias).sum(0).view(1, j * c)
            return torch.addmm(shift, flat, folded).view(batch, j, c)

        b_ij = torch.zeros((d, j), dtype=u.dtype, device=u.device)
        with trace.span("cap.transform", call):
            s = weighted_sum(b_ij)
        CAPModule.u_hat_bytes = 0
        products = 1
        with trace.span("cap.routing", call):
            for round_ in range(self.iter_routing):
                if round_:
                    s = weighted_sum(b_ij)
                    products += 1
                v = squash(s, dim=2)
                if round_ + 1 < self.iter_routing:  # the last round's agreement is unused
                    # a[d, j] = sum_(p, c) w[d, p, j, c] (U^T V)[d, p, j, c]
                    #           + sum_c b_lin[d, j, c] sum_b v[b, j, c]
                    m = torch.mm(flat.t(), v.view(batch, j * c)).view(d, p, j, c)
                    agreement = (w * m).sum((1, 3)) + (bias * v.sum(0)).sum(2)
                    products += 1
                    if self.mesh is not None and self.mesh.sharded:
                        agreement = self.mesh.all_reduce_sum(agreement)
                    b_ij = b_ij + agreement

            y_conv = torch.linalg.vector_norm(v, dim=2)  # [B, J]
        CAPModule.routing_products = products
        CAPModule.routes["folded"] += 1
        return v.permute(1, 2, 0), y_conv, b_ij

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> ModelOutput:
        """``x``: NHWC float32 patches ``[B, k, k, C]``; ``labels``: one-hot
        ``[B, classes]``, which the decoder needs in train mode. CAP has no
        dropout; ``dropout_generator`` is accepted for the trainer's call."""
        batch = x.shape[0]
        call = next(_FORWARDS)
        net = self.PrimaryCaps_layer(self.Conv1_layer(x.permute(0, 3, 1, 2)))
        u = net.permute(0, 2, 3, 1).reshape(batch, self.data_size, self.pco)  # NHWC order, as in JAX
        recorded = torch.is_grad_enabled() and (
            u.requires_grad or self.digitcaps_w.requires_grad or self.digitcaps_b.requires_grad)
        v, y_conv, _ = (self.u_hat_route if recorded else self.folded_route)(u, call)

        decoder_out = None
        if self.training and self.enable_decoding and labels is not None:
            masked_v = torch.einsum("jcb,bj->bc", v, labels.to(v.dtype))
            decoder_out = self.decoder_fc3(self.decoder_fc2(self.decoder_fc1(masked_v)))
        return ModelOutput(y_conv=y_conv, image_output=decoder_out, image_original=x,
                           histograms={})


def margin_loss(logits: torch.Tensor, labels_onehot: torch.Tensor,
                x_output: Optional[torch.Tensor] = None,
                x_original: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The capsule margin loss (``hypelcnn_tpu/models/cap.py:margin_loss``):
    implemented, and unused by :class:`CAPModel`, as in the reference."""
    labels_f = labels_onehot.to(torch.float32)
    m_plus, m_minus, lambda_val = 0.9, 0.1, 0.5
    max_l = torch.square(torch.clamp(m_plus - logits, min=0.0))
    max_r = torch.square(torch.clamp(logits - m_minus, min=0.0))
    l_c = labels_f * max_l + lambda_val * (1.0 - labels_f) * max_r
    loss = torch.mean(torch.sum(l_c, dim=1))
    if x_output is not None:
        origin = x_original.reshape(x_original.shape[0], -1)
        loss = loss + 0.0005 * torch.mean(torch.square(x_output - origin))
    return loss


@register_model("CAPModel")
class CAPModel(NNModel):
    def default_params(self) -> Dict[str, Any]:
        return dict(DEFAULT_PARAMS)

    def create_module(self, class_count: int, algorithm_params: Dict[str, Any],
                      data_shape: Sequence[int]) -> CAPModule:
        return CAPModule(class_count, {**DEFAULT_PARAMS, **algorithm_params}, data_shape)

    def loss(self, output: ModelOutput, labels_onehot: torch.Tensor) -> torch.Tensor:
        """Cross-entropy, plus the reconstruction MSE in train mode."""
        ce = softmax_cross_entropy(output.y_conv, labels_onehot)
        if output.image_output is None:
            return ce
        return ce + reconstruction_loss(output)
