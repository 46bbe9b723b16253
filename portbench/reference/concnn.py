"""CONCNN, the contextual CNN of H. Lee and H. Kwon ("Going Deeper with
Contextual CNN for Hyperspectral Image Classification", IEEE TIP 26(10),
2017) as github.com/aligokalppeker/hypelcnn builds it
(``nnmodel/CONCNNModel.py``), in plain PyTorch and float32.

On a ``[B, k, k, C]`` window (NHWC), every convolution SAME with a bias and
ReLU:

1. A multi-scale filter bank: parallel 1x1, 3x3 and 5x5 convolutions of
   ``f`` filters each, concatenated to ``3f`` channels, then local response
   normalization (LRN).
2. ``conv11`` (1x1, ``3f``), then LRN.
3. Two residual stacks: ``conv13(conv12(.)) + .`` and ``conv22(conv21(.)) +
   .``, every convolution a 1x1 of ``3f`` filters.
4. ``conv31`` and ``conv32``, each followed by dropout in training, then
   ``conv33``.
5. The features flattened in (row, column, channel) order and a linear logit
   layer ``fc``.

LRN is TensorFlow's ``tf.nn.local_response_normalization`` with the
source's defaults (depth radius 5, bias 1, alpha 1, beta 0.5): each channel
divided by ``(bias + alpha * s) ** beta``, where ``s`` is the plain sum of
the squares of the ``2r + 1`` channels around it, the window clipped at the
first and the last channel. Here that sum is taken as written, window by
window; the program takes it as a difference of cumulative sums, as the JAX
package does, which rounds otherwise in float32.

Dropout drops with rate ``1 - drop_out_ratio`` (the published parameter is
a keep probability). No batch norm; kernels drawn Glorot-uniform, biases 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from portbench.reference.common import (
    Norms,
    Op,
    Param,
    conv,
    conv_params,
    cross_entropy,
    dense,
    dense_params,
    dropout,
)

# tf.nn.local_response_normalization as the source calls it: TF's defaults
DEPTH_RADIUS, LRN_BIAS, LRN_ALPHA, LRN_BETA = 5, 1.0, 1.0, 0.5
STACK = ("conv11", "conv12", "conv13", "conv21", "conv22", "conv31", "conv32", "conv33")


def local_response_normalization(x: torch.Tensor, depth_radius: int = DEPTH_RADIUS,
                                 bias: float = LRN_BIAS, alpha: float = LRN_ALPHA,
                                 beta: float = LRN_BETA) -> torch.Tensor:
    """TF's LRN over the channels of NCHW ``x``: for each channel ``c``,
    ``x / (bias + alpha * sum(x[c'] ** 2 for |c' - c| <= r)) ** beta``, the
    channels ``c'`` clipped to the tensor's."""
    channels = x.shape[1]
    sq = x * x
    sums = torch.stack([sq[:, max(0, c - depth_radius):c + depth_radius + 1].sum(dim=1)
                        for c in range(channels)], dim=1)
    return x / (bias + alpha * sums) ** beta


class Model:
    output_bias = "fc.Dense_0.bias"  # the logit layer's bias
    lrn_calls = 2  # LRNs a forward, each over every feature of the window

    def __init__(self, params: Dict, class_count: int, data_shape: Sequence[int]):
        self.p = params
        k, _, channels = data_shape
        self.k, self.channels, self.classes = k, channels, class_count
        f = params["filter_count"]
        self.width = 3 * f
        self.bank = [(f"conv0_{s}x{s}", channels, f, s) for s in (1, 3, 5)]
        self.stack = [(name, self.width, self.width, 1) for name in STACK]
        self.features = k * k * self.width
        self.rate = 1.0 - params["drop_out_ratio"]

    # ---- structure ----

    def params(self) -> List[Param]:
        spec = []
        for name, cin, cout, s in self.bank + self.stack:
            spec += conv_params(name, cin, cout, s, False, "xavier")
        return spec + dense_params("fc", self.features, self.classes, False, "xavier")

    def ops(self) -> List[Op]:
        pixels = self.k * self.k
        out = [Op("conv", pixels * cout * cin * s * s, reads_input=True)
               for _, cin, cout, s in self.bank]
        out += [Op("conv", pixels * cout * cin) for _, cin, cout, _ in self.stack]
        return out + [Op("dense", self.features * self.classes)]

    def lrn_elements(self) -> int:
        """Elements each LRN normalizes a window: all ``3f`` channels at every pixel."""
        return self.k * self.k * self.width

    # ---- forward ----

    def forward(self, w: Dict[str, torch.Tensor], x: torch.Tensor, norms: Norms,
                train: bool = False, dropout_gen: Optional[torch.Generator] = None):
        relu = torch.relu
        h = x.permute(0, 3, 1, 2)
        net0 = torch.cat([conv(w, name, h, None, relu) for name, *_ in self.bank], dim=1)
        net0 = local_response_normalization(net0)
        net11 = local_response_normalization(conv(w, "conv11", net0, None, relu))
        net13 = conv(w, "conv13", conv(w, "conv12", net11, None, relu), None, relu) + net11
        net22 = conv(w, "conv22", conv(w, "conv21", net13, None, relu), None, relu) + net13
        net = net22
        for name in ("conv31", "conv32"):
            net = conv(w, name, net, None, relu)
            if train:
                net = dropout(net, self.rate, dropout_gen)
        net33 = conv(w, "conv33", net, None, relu)
        feats = net33.permute(0, 2, 3, 1).reshape(net33.shape[0], -1)
        return dense(w, "fc", feats, None, None), None

    def loss(self, logits, image, x, onehot) -> torch.Tensor:
        return cross_entropy(logits, onehot).mean()
