"""HYPELCNN, the hyperspectral + LiDAR CNN of github.com/aligokalppeker/hypelcnn
(``nnmodel/HYPELCNNModel.py``), in plain PyTorch and float32.

On a ``[B, k, k, C]`` window (NHWC):

1. A spectral encoder of 1x1 convolutions widening to ``filter_count``
   (``f/4, f/2, f`` for three levels), then a decoder narrowing back
   (``f, f/2, f/4``); each convolution is followed by batch norm and leaky
   ReLU, and each is residual (its input's channels matched to its output's
   and added). Each stack as a whole is residual on its input too.
2. Spatial levels: parallel SAME convolutions of every odd size up to k,
   concatenated, residual on the level's input, then a 1x1 connector
   convolution, residual on its own input. The whole is residual on its input.
3. The features flattened in (row, column, channel) order, a pyramid of
   fully connected layers shrinking by ``degradation_coeff`` each, with
   dropout after each, and a batch-normalized logit layer without activation.
4. In training only, four dense layers reconstruct the window from the
   logits (the last with a sigmoid); the loss adds their mean squared
   error against the input window to the cross-entropy.

Every product is followed by batch norm with a bias and no scale (so no
product has a bias of its own). Kernels are drawn He-style from a normal
truncated at two standard deviations.
"""

from __future__ import annotations

import functools
import math
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
    leaky_relu,
    match_channels,
)


class Model:
    output_bias = "fc_final.BatchNorm_0.bias"  # the logit layer's bias

    def __init__(self, params: Dict, class_count: int, data_shape: Sequence[int]):
        self.p = params
        k, _, channels = data_shape
        self.k, self.channels, self.classes = k, channels, class_count
        f = params["filter_count"]
        levels = params["spectral_hierarchy_level"]
        self.encoder = [(f"conv_enc_{i}", f // 2 ** (levels - 1 - i)) for i in range(levels)]
        self.decoder = [(f"conv_dec_{i}", f // 2 ** i) for i in range(levels)]
        self.kernel_sizes = list(range(1, k + 1, 2))
        level_filters = self.decoder[-1][1] // 2
        self.levels = [(index, level_filters // 2 ** index)
                       for index in range(params["spatial_hierarchy_level"])]
        flatten = k * k * self.levels[-1][1] * len(self.kernel_sizes)
        degradation = params["degradation_coeff"]
        stages = math.floor(math.log(flatten / class_count, degradation))
        self.fc = []
        size = flatten
        for stage in range(stages - 1):
            self.fc.append((f"fc_{stage}", size, size // degradation))
            size //= degradation
        self.fc_final_in = size
        self.gen = [("image_gen_net_1", class_count, class_count * 3),
                    ("image_gen_net_2", class_count * 3, class_count * 9),
                    ("image_gen_net_3", class_count * 9, class_count * 27),
                    ("image_gen_net_4", class_count * 27, k * k * channels)]

    # ---- structure ----

    def _convs(self):
        """(name, in, out, kernel, reads_input) of every convolution, in order."""
        out = []
        width = self.channels
        for name, feat in self.encoder + self.decoder:
            out.append((name, width, feat, 1, name == self.encoder[0][0]))
            width = feat
        for index, feat in self.levels:
            for k in self.kernel_sizes:
                out.append((f"connector_{index}_conv{k}x{k}", width, feat, k, False))
            width = feat * len(self.kernel_sizes)
            out.append((f"connector_conv_{index}", width, width, 1, False))
        return out

    def params(self) -> List[Param]:
        spec = []
        for name, cin, cout, k, _ in self._convs():
            spec += conv_params(name, cin, cout, k, True, "he_truncated")
        for name, cin, cout in self.fc + [("fc_final", self.fc_final_in, self.classes)] + self.gen:
            spec += dense_params(name, cin, cout, True, "he_truncated")
        return spec

    def ops(self) -> List[Op]:
        pixels = self.k * self.k
        out = [Op("conv", pixels * cout * cin * k * k, reads_input=first)
               for _, cin, cout, k, first in self._convs()]
        out += [Op("dense", cin * cout) for _, cin, cout in
                self.fc + [("fc_final", self.fc_final_in, self.classes)]]
        out += [Op("dense", cin * cout, train_only=True) for _, cin, cout in self.gen]
        return out

    # ---- forward ----

    def forward(self, w: Dict[str, torch.Tensor], x: torch.Tensor, norms: Norms,
                train: bool = False, dropout_gen: Optional[torch.Generator] = None):
        """Logits of NHWC windows ``x``, and in training the reconstruction."""
        act = functools.partial(leaky_relu, alpha=self.p["lrelu_alpha"])

        def residual(inp, out):
            return out + match_channels(inp, out.shape[1])

        def stack(inp, names):
            h = inp
            for name, _ in names:
                h = residual(h, conv(w, name, h, norms, act))
            return residual(inp, h)

        net0 = x.permute(0, 3, 1, 2)
        net1 = stack(net0, self.encoder)
        net2 = stack(net1, self.decoder)
        h = net2
        for index, _ in self.levels:
            level = torch.cat([conv(w, f"connector_{index}_conv{k}x{k}", h, norms, act)
                               for k in self.kernel_sizes], dim=1)
            nxt = residual(h, level)
            h = conv(w, f"connector_conv_{index}", nxt, norms, act) + nxt
        net3 = residual(net2, h)
        feats = net3.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        for name, _, _ in self.fc:
            feats = dense(w, name, feats, norms, act)
            if train:
                feats = dropout(feats, self.p["drop_out_ratio"], dropout_gen)
        logits = dense(w, "fc_final", feats, norms, None)
        if not train:
            return logits, None
        g = logits
        for name, _, _ in self.gen[:-1]:
            g = dense(w, name, g, norms, act)
        image = dense(w, self.gen[-1][0], g, norms, torch.sigmoid)
        return logits, image

    def loss(self, logits, image, x, onehot) -> torch.Tensor:
        """Mean cross-entropy plus the reconstruction's mean squared error."""
        ce = cross_entropy(logits, onehot)
        if image is not None:
            ce = ce + torch.mean(torch.square(image - x.reshape(x.shape[0], -1)))
        return ce.mean()
