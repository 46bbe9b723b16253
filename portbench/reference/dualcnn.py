"""DUALCNN, the two-branch CNN of github.com/aligokalppeker/hypelcnn
(``nnmodel/DUALCNNModel.py``), in plain PyTorch and float32.

On a ``[B, k, k, C]`` window (NHWC) whose last channel is LiDAR:

1. The hyperspectral channels, cropped by ``hs_lidar_diff`` on each side
   (when the window is wider than one pixel), pass 8 levels of widths
   ``f/4, f/2, f, f/2, f/4, f/8, f/16, f/32``; the LiDAR channel passes 3
   levels of widths 2, 4 and 8. A level is parallel SAME convolutions of
   every odd size up to the branch's window, concatenated, then a 1x1
   connector convolution; every convolution has a bias and leaky ReLU.
2. Both branches flattened in (row, column, channel) order, hyperspectral
   first, then dense layers of ``9c``, ``6c`` and ``3c`` units (c classes)
   with leaky ReLU, each followed by dropout, and a linear logit layer.

Dropout drops with rate ``1 - drop_out_ratio`` (the published parameter is
a keep probability). No batch norm; kernels drawn Glorot-uniform, biases 0.
"""

from __future__ import annotations

import functools
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
)


class Model:
    output_bias = "fc4.Dense_0.bias"  # the logit layer's bias

    def __init__(self, params: Dict, class_count: int, data_shape: Sequence[int]):
        self.p = params
        k, _, channels = data_shape
        self.k, self.channels, self.classes = k, channels, class_count
        self.diff = params["hs_lidar_diff"]
        self.hsi_k = k - 2 * self.diff if k > 1 and self.diff > 0 else k
        f = params["filter_count"]
        self.hsi = self._branch("", channels - 1, self.hsi_k,
                                [f // 4, f // 2, f, f // 2, f // 4, f // 8, f // 16, f // 32])
        self.lidar = self._branch("lidar_", 1, k, [2, 4, 8])
        width = self.hsi_k ** 2 * self.hsi[-1][1][2] + k * k * self.lidar[-1][1][2]
        self.fc = []
        for i, units in enumerate([class_count * 9, class_count * 6, class_count * 3], start=1):
            self.fc.append((f"fc{i}", width, units))
            width = units
        self.fc.append(("fc4", width, class_count))
        self.rate = 1.0 - params["drop_out_ratio"]

    @staticmethod
    def _branch(prefix: str, width: int, k: int, filters: Sequence[int]):
        """Per level: ([(name, in, out, kernel) of each branch conv], connector)."""
        sizes = range(1, k + 1, 2)
        levels = []
        for i, feat in enumerate(filters, start=1):
            convs = [(f"{prefix}level{i}_conv{s}x{s}", width, feat, s) for s in sizes]
            width = feat * len(sizes)
            levels.append((convs, (f"{prefix}connector_conv{i}", width, width, 1)))
        return levels

    # ---- structure ----

    def params(self) -> List[Param]:
        spec = []
        for levels in (self.hsi, self.lidar):
            for convs, connector in levels:
                for name, cin, cout, s in convs + [connector]:
                    spec += conv_params(name, cin, cout, s, False, "xavier")
        for name, cin, cout in self.fc:
            spec += dense_params(name, cin, cout, False, "xavier")
        return spec

    def ops(self) -> List[Op]:
        out = []
        for levels, k in ((self.hsi, self.hsi_k), (self.lidar, self.k)):
            for index, (convs, connector) in enumerate(levels):
                for _, cin, cout, s in convs:
                    out.append(Op("conv", k * k * cout * cin * s * s, reads_input=index == 0))
                _, cin, cout, s = connector
                out.append(Op("conv", k * k * cout * cin * s * s))
        return out + [Op("dense", cin * cout) for _, cin, cout in self.fc]

    # ---- forward ----

    def forward(self, w: Dict[str, torch.Tensor], x: torch.Tensor, norms: Norms,
                train: bool = False, dropout_gen: Optional[torch.Generator] = None):
        act = functools.partial(leaky_relu, alpha=self.p["lrelu_alpha"])
        hsi, lidar = x[..., :-1], x[..., -1:]
        d = self.diff
        if self.hsi_k != self.k:
            hsi = hsi[:, d:-d, d:-d, :]

        def branch(h, levels):
            h = h.permute(0, 3, 1, 2)
            for convs, connector in levels:
                h = torch.cat([conv(w, name, h, None, act) for name, *_ in convs], dim=1)
                h = conv(w, connector[0], h, None, act)
            return h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)

        feats = torch.cat([branch(hsi, self.hsi), branch(lidar, self.lidar)], dim=1)
        for name, _, _ in self.fc[:-1]:
            feats = dense(w, name, feats, None, act)
            if train:
                feats = dropout(feats, self.rate, dropout_gen)
        return dense(w, "fc4", feats, None, None), None

    def loss(self, logits, image, x, onehot) -> torch.Tensor:
        return cross_entropy(logits, onehot).mean()
