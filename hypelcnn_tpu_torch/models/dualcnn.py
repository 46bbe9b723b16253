"""DUALCNN, the two-branch HSI / LiDAR fusion CNN (``hypelcnn_tpu/models/dualcnn.py``).

- The input's channels split into HSI (all but the last) and LiDAR (the
  last). When the patch is larger than 1x1, the HSI patch is cropped by
  ``hs_lidar_diff`` on each side.
- 8 HSI levels and 3 LiDAR levels (2, 4 and 8 filters), each a multi-scale
  level (parallel odd k x k SAME convolutions up to the branch's patch,
  concatenated; or, with ``fuse_level_convs``, one
  :class:`~hypelcnn_tpu_torch.models.layers.FusedMultiScaleLevel`) followed by
  a 1x1 connector convolution.
- Both branches flattened in HWC order, HSI first, then FC 9c / 6c / 3c with
  dropout and a linear ``fc4``.
- Leaky-ReLU, xavier init, biases, no batch norm; softmax cross-entropy.
- Activations are NCHW views of channels-last memory for
  :func:`~hypelcnn_tpu_torch.models.layers.conv2d`: a convolution whose
  kernel covers its window (the HSI 3x3 on the cropped 3x3 patch, the
  LiDAR 5x5 on the 5x5 one) is one GEMM against its Toeplitz weight; the
  1x1 connectors and the LiDAR 3x3 go to cuDNN.

Dropout drops with rate ``1 - drop_out_ratio`` (the reference's keep-prob
quirk, kept by the JAX package): it is off at ``drop_out_ratio = 1.0``.

``compute_dtype: "bfloat16"`` runs both branches' convolutions in bfloat16;
the FC head, which the JAX module builds without a dtype, computes in
float32 from the bfloat16 features, and the logits are float32.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from hypelcnn_tpu_torch.core.registry import register_model
from hypelcnn_tpu_torch.models.base import ModelOutput, NNModel, softmax_cross_entropy
from hypelcnn_tpu_torch.models.layers import (
    Dropout,
    FusedMultiScaleLevel,
    SlimConv,
    SlimDense,
    compute_dtype,
    level_kernel_sizes,
    multi_scale_level,
)
from hypelcnn_tpu_torch.ops.nn import leaky_relu

DEFAULT_PARAMS: Dict[str, Any] = {
    # matches configs/modelconfigs/alg_param_dualcnn.json
    "batch_size": 48,
    "drop_out_ratio": 0.70,
    "learning_rate": 3e-4,
    "learning_rate_decay_factor": 0.96,
    "learning_rate_decay_step": 350,
    "lrelu_alpha": 0.18,
    "filter_count": 480,
    "optimizer": "AdamOptimizer",
    "hs_lidar_diff": 1,
    "l2regularizer_scale": 1e-5,
    "compute_dtype": "float32",
}


class DUALCNNModule(nn.Module):
    def __init__(self, class_count: int, params_dict: Dict[str, Any], data_shape: Sequence[int]):
        super().__init__()
        p = params_dict
        self.dtype = compute_dtype(p)
        patch, patch_w, in_channels = data_shape
        if patch != patch_w:
            raise ValueError(f"DUALCNN takes square patches, got {list(data_shape)}")
        self.diff = p["hs_lidar_diff"]
        hsi_patch = patch - 2 * self.diff if patch > 1 and self.diff > 0 else patch
        self.act = functools.partial(leaky_relu, alpha=p["lrelu_alpha"])
        self.fuse = p.get("fuse_level_convs", False)

        fc = p["filter_count"]
        self.hsi_levels = self._branch(
            "", in_channels - 1, hsi_patch,
            [fc // 4, fc // 2, fc, fc // 2, fc // 4, fc // 8, fc // 16, fc // 32])
        self.lidar_levels = self._branch("lidar_", 1, patch, [2, 4, 8])
        width = hsi_patch * hsi_patch * self.hsi_levels[-1][1].Conv_0.out_channels \
            + patch * patch * self.lidar_levels[-1][1].Conv_0.out_channels

        self.fc_stages = []
        for i, feat in enumerate([class_count * 9, class_count * 6, class_count * 3], start=1):
            layer = SlimDense(width, feat, activation=self.act)
            self.add_module(f"fc{i}", layer)
            self.fc_stages.append(layer)
            width = feat
        self.fc4 = SlimDense(width, class_count, activation=None)
        self.dropout = Dropout(1.0 - p["drop_out_ratio"])

    def _branch(self, prefix: str, width: int, patch: int, filters: Sequence[int]
                ) -> List[Tuple[List[nn.Module], SlimConv]]:
        levels = []
        kernel_sizes = level_kernel_sizes(patch)
        for i, feat in enumerate(filters, start=1):
            if self.fuse:
                branches = [FusedMultiScaleLevel(width, feat, patch, activation=self.act,
                                                 dtype=self.dtype)]
                self.add_module(f"{prefix}level{i}_fused", branches[0])
            else:
                branches = []
                for k in kernel_sizes:
                    branches.append(SlimConv(width, feat, k, activation=self.act,
                                             dtype=self.dtype))
                    self.add_module(f"{prefix}level{i}_conv{k}x{k}", branches[-1])
            width = feat * len(kernel_sizes)
            connector = SlimConv(width, width, 1, activation=self.act, dtype=self.dtype)
            self.add_module(f"{prefix}connector_conv{i}", connector)
            levels.append((branches, connector))
        return levels

    @staticmethod
    def _run(x: torch.Tensor, levels) -> torch.Tensor:
        for branches, connector in levels:
            x = connector(multi_scale_level(x, branches))
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> ModelOutput:
        """``x``: NHWC float32 patches ``[B, k, k, C]``; ``dropout_generator``
        draws the dropout masks in train mode."""
        x = x.to(self.dtype)
        hsi, lidar = x[..., :-1], x[..., -1:]
        d = self.diff
        if (hsi.shape[1] > 1 or hsi.shape[2] > 1) and d > 0:
            hsi = hsi[:, d:-d, d:-d, :]
        net = torch.cat([self._run(hsi.permute(0, 3, 1, 2), self.hsi_levels),
                         self._run(lidar.permute(0, 3, 1, 2), self.lidar_levels)], dim=1)
        for stage in self.fc_stages:
            net = self.dropout(stage(net), dropout_generator)
        logits = self.fc4(net)
        return ModelOutput(y_conv=logits, image_output=None, image_original=None, histograms={})


@register_model("DUALCNNModel")
class DUALCNNModel(NNModel):
    def default_params(self) -> Dict[str, Any]:
        return dict(DEFAULT_PARAMS)

    def create_module(self, class_count: int, algorithm_params: Dict[str, Any],
                      data_shape: Sequence[int]) -> DUALCNNModule:
        return DUALCNNModule(class_count, {**DEFAULT_PARAMS, **algorithm_params}, data_shape)

    def loss(self, output: ModelOutput, labels_onehot: torch.Tensor) -> torch.Tensor:
        return softmax_cross_entropy(output.y_conv, labels_onehot)
