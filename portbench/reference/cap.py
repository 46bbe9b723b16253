"""CAP, the capsule network of github.com/aligokalppeker/hypelcnn
(``nnmodel/CAPModel.py``), after Sabour, Frosst and Hinton, "Dynamic Routing
Between Capsules" (NeurIPS 2017, arXiv:1710.09829), in plain PyTorch and
float32.

On a ``[B, k, k, C]`` window (NHWC):

1. A stem: a VALID convolution (``conv_layer_kernel_size``) to
   ``feature_count`` features, batch norm, ReLU.
2. PrimaryCaps: a VALID convolution (``primary_caps_kernel_size``) to
   ``primary_capsule_count * P`` features, batch norm, ReLU; flattened in
   (row, column, channel) order into ``D`` input capsules ``u`` of ``P``
   values.
3. The prediction vectors: each input capsule's own linear map,
   ``u_hat[b, d] = u[b, d] @ W[d] + bias[d]``, to ``J`` digit capsules of
   ``C`` values (``W`` is ``[D, P, J*C]``).
4. ``iter_routing`` rounds of routing by agreement from logits ``b[d, j] = 0``:
   couplings ``c = softmax(b)`` over the classes; ``s[b, j] = sum_d c[d, j]
   u_hat[b, d, j]``; ``v = squash(s)``; after every round but the last,
   ``b[d, j] += sum_b <u_hat[b, d, j], v[b, j]>``.
5. The class scores: the L2 norms ``|v[b, j]|``.
6. In training with labels, a decoder reconstructs the window from the
   label's capsule ``sum_j y[b, j] v[b, j]``: dense layers of 512 and 1,024
   leaky-ReLU units and a sigmoid layer of ``k*k*C`` units, each with a bias;
   the loss is the mean of the softmax cross-entropy of the scores plus the
   reconstruction's mean squared error against the window.

Batch norm has a bias and no scale (eps 1e-3), and no product before it has a
bias. Departures from Sabour et al., as the source has them and the program
keeps them:

- ``squash`` divides by the MEAN of squares over the capsule's values,
  ``n2 = mean(s^2)``, ``v = n2 / (1 + n2) * s / sqrt(n2)``, not ``|s|^2``;
- ``P``, the primary capsules' width, is read from
  ``digit_capsule_output_space`` (16), not ``primary_capsule_output_space``
  (8); the primary capsules are ReLU outputs, not squashed;
- batch norm normalizes with the batch's moments in evaluation too (the
  source never passes ``is_training`` to tf-slim's batch norm), so
  :meth:`Model.forward` ignores ``norms.mode``;
- the routing logits are one ``[D, J]`` table for the whole batch, and the
  agreement is summed over the batch, so a window's class depends on every
  other window of its batch;
- the prediction vectors have a bias (``digitcaps_b``);
- the loss is softmax cross-entropy on the capsule norms plus the
  reconstruction's error at weight 1, not the margin loss with 0.0005; the
  decoder reads the label's ``C`` values (the masked capsules summed over
  the classes), not all ``J*C``, and its hidden layers are leaky ReLUs.

The stem and PrimaryCaps are the published 1x1 convolutions on a 3 x 3
window, where Sabour et al. have 9 x 9 convolutions on 28 x 28 digits.
Kernels are drawn Glorot-uniform, ``W`` per input capsule (fan-in ``P``,
fan-out ``J*C``); biases 0.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    Norms,
    Op,
    Param,
    batch_norm,
    conv_params,
    cross_entropy,
    dense,
    dense_params,
    leaky_relu,
)

def squash(s: torch.Tensor) -> torch.Tensor:
    """The source's squash over the last axis, with the mean of squares."""
    n2 = torch.mean(s * s, dim=-1, keepdim=True)
    return n2 / (1.0 + n2) * s / torch.sqrt(n2 + 1e-9)


class Model:
    def __init__(self, params: Dict, class_count: int, data_shape: Sequence[int]):
        self.p = params
        k, _, channels = data_shape
        self.k, self.channels, self.classes = k, channels, class_count
        self.ck, self.pk = params["conv_layer_kernel_size"], params["primary_caps_kernel_size"]
        self.features = params["feature_count"]
        self.pco = self.dco = params["digit_capsule_output_space"]
        self.primary = params["primary_capsule_count"] * self.pco
        self.stem_side = k - self.ck + 1
        self.side = self.stem_side - self.pk + 1
        self.data_size = self.side * self.side * params["primary_capsule_count"]
        self.rounds = params["iter_routing"]
        self.decoder = [("decoder_fc1", self.dco, 512), ("decoder_fc2", 512, 1024),
                        ("decoder_fc3", 1024, k * k * channels)]

    # ---- structure ----

    def params(self) -> List[Param]:
        spec = conv_params("Conv1_layer", self.channels, self.features, self.ck, True, "xavier")
        spec += conv_params("PrimaryCaps_layer", self.features, self.primary, self.pk, True,
                            "xavier")
        q = self.classes * self.dco
        spec += [Param("digitcaps_w", (self.data_size, self.pco, q), "xavier"),
                 Param("digitcaps_b", (self.data_size, q), "zeros")]
        for name, cin, cout in self.decoder:
            spec += dense_params(name, cin, cout, False, "xavier")
        return spec

    def ops(self) -> List[Op]:
        q = self.classes * self.dco
        return [
            Op("conv", self.stem_side ** 2 * self.features * self.channels * self.ck ** 2,
               reads_input=True),
            Op("conv", self.side ** 2 * self.primary * self.features * self.pk ** 2),
            Op("transform", self.data_size * self.pco * q),
            # r weighted sums and r - 1 agreements, each one multiply-add per prediction value
            Op("routing", (2 * self.rounds - 1) * self.data_size * q),
        ] + [Op("dense", cin * cout, train_only=True) for _, cin, cout in self.decoder]

    # ---- forward ----

    def forward(self, w: Dict[str, torch.Tensor], x: torch.Tensor, norms: Norms,
                train: bool = False, dropout_gen: Optional[torch.Generator] = None,
                labels: Optional[torch.Tensor] = None):
        """Class scores of NHWC windows ``x``, and in training with one-hot
        ``labels`` the reconstruction. Batch norm takes the batch's moments
        (recorded in ``norms.record`` where given, with the last round's
        routing logits under ``"routing_logits"``). CAP has no dropout."""
        batch_norms = Norms("batch", norms.record)

        def conv_bn_relu(name, h):
            y = F.conv2d(h, w[f"{name}.Conv_0.weight"])
            return torch.relu(batch_norm(w, f"{name}.BatchNorm_0", y, batch_norms))

        h = conv_bn_relu("PrimaryCaps_layer", conv_bn_relu("Conv1_layer", x.permute(0, 3, 1, 2)))
        u = h.permute(0, 2, 3, 1).reshape(x.shape[0], self.data_size, self.pco)
        u_hat = torch.einsum("bdp,dpq->bdq", u, w["digitcaps_w"]) + w["digitcaps_b"]
        u_hat = u_hat.reshape(x.shape[0], self.data_size, self.classes, self.dco)
        logits = torch.zeros(self.data_size, self.classes, dtype=u_hat.dtype, device=x.device)
        for round_ in range(self.rounds):
            couplings = torch.softmax(logits, dim=1)
            v = squash(torch.einsum("bdjc,dj->bjc", u_hat, couplings))
            if round_ + 1 < self.rounds:
                # over the batch for each capsule value, then over the values: a float32 sum
                # of all B*C products at once is ~6x less accurate, and a near tie in the
                # logits amplifies that ~1,000x into the next round's
                logits = logits + torch.einsum("bdjc,bjc->djc", u_hat, v).sum(-1)
        if norms.record is not None:
            norms.record["routing_logits"] = logits.detach()
        scores = torch.linalg.vector_norm(v, dim=-1)  # its gradient at 0 is 0
        if not (train and self.p["enable_decoding"] and labels is not None):
            return scores, None
        g = torch.sum(v * labels[:, :, None], dim=1)
        act = functools.partial(leaky_relu, alpha=self.p["lrelu_alpha"])
        for name, _, _ in self.decoder[:-1]:
            g = dense(w, name, g, None, act)
        return scores, dense(w, self.decoder[-1][0], g, None, torch.sigmoid)

    def loss(self, logits, image, x, onehot) -> torch.Tensor:
        """Mean cross-entropy plus the reconstruction's mean squared error."""
        ce = cross_entropy(logits, onehot)
        if image is not None:
            ce = ce + torch.mean(torch.square(image - x.reshape(x.shape[0], -1)))
        return ce.mean()
