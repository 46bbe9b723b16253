"""CONCNN, the context CNN with an inception-style front end
(``hypelcnn_tpu/models/concnn.py``).

- parallel 1x1 / 3x3 / 5x5 SAME convolutions, concatenated, then local
  response normalization;
- residual stacks of 1x1 convolutions, two of them followed by dropout;
- a linear ``fc`` head over the flattened features;
- ReLU, xavier init, conv biases, no batch norm; softmax cross-entropy.

Dropout drops with rate ``1 - drop_out_ratio``: the JAX package keeps the
reference's quirk of passing ``drop_out_ratio`` as tf-slim's keep
probability, so dropout is off at ``drop_out_ratio = 1.0``.

The public forward takes NHWC, as the JAX module does; inside, activations
are NCHW. The flatten before ``fc`` is in HWC order, as in JAX.

``compute_dtype: "bfloat16"`` runs the convolutions, LRN and dropout in
bfloat16; ``fc``, which the JAX module builds without a dtype, computes in
float32 from the bfloat16 features, and the logits are float32.

Spans (``core/trace.py``; the forward's call number is their id):
``concnn.front`` around the three bank convolutions and their concatenation,
``concnn.lrn`` around each LRN, with index 0 after the bank and 1 after
``conv11``. ``ops/nn.py`` counts the LRN calls and the elements they
normalized (``local_response_normalization.calls`` and ``.elements``).
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from hypelcnn_tpu_torch.core import trace
from hypelcnn_tpu_torch.core.registry import register_model
from hypelcnn_tpu_torch.models.base import ModelOutput, NNModel, softmax_cross_entropy
from hypelcnn_tpu_torch.models.layers import Dropout, SlimConv, SlimDense, compute_dtype
from hypelcnn_tpu_torch.ops.nn import local_response_normalization

DEFAULT_PARAMS: Dict[str, Any] = {
    # matches configs/modelconfigs/alg_param_concnn.json
    "batch_size": 10,
    "drop_out_ratio": 0.5,
    "learning_rate": 0.001,
    "learning_rate_decay_factor": 0.01,
    "learning_rate_decay_step": 33333,
    "filter_count": 128,
    "optimizer": ["MomentumOptimizer", 0.9],
    "compute_dtype": "float32",
}
_FORWARDS = itertools.count()  # a forward's call number, the id of its spans


class CONCNNModule(nn.Module):
    def __init__(self, class_count: int, params_dict: Dict[str, Any], data_shape: Sequence[int]):
        super().__init__()
        p = params_dict
        self.dtype = dtype = compute_dtype(p)
        patch, patch_w, in_channels = data_shape
        f0 = p["filter_count"]
        f1 = 3 * f0
        self.conv0_1x1 = SlimConv(in_channels, f0, 1, dtype=dtype)
        self.conv0_3x3 = SlimConv(in_channels, f0, 3, dtype=dtype)
        self.conv0_5x5 = SlimConv(in_channels, f0, 5, dtype=dtype)
        for name in ("conv11", "conv12", "conv13", "conv21", "conv22", "conv31", "conv32",
                     "conv33"):
            self.add_module(name, SlimConv(f1, f1, 1, dtype=dtype))
        self.dropout = Dropout(1.0 - p["drop_out_ratio"])
        self.fc = SlimDense(patch * patch_w * f1, class_count, activation=None)

    def forward(self, x: torch.Tensor, labels: Optional[torch.Tensor] = None,
                dropout_generator: Optional[torch.Generator] = None) -> ModelOutput:
        """``x``: NHWC float32 patches ``[B, k, k, C]``; ``dropout_generator``
        draws the dropout masks in train mode."""
        call = next(_FORWARDS)
        net = x.to(self.dtype).permute(0, 3, 1, 2)
        with trace.span("concnn.front", call):
            net0 = torch.cat([self.conv0_1x1(net), self.conv0_3x3(net), self.conv0_5x5(net)],
                             dim=1)
        with trace.span("concnn.lrn", call, 0):
            net0 = local_response_normalization(net0)
        net11 = self.conv11(net0)
        with trace.span("concnn.lrn", call, 1):
            net11 = local_response_normalization(net11)
        net13 = self.conv13(self.conv12(net11)) + net11
        net22 = self.conv22(self.conv21(net13)) + net13
        net31 = self.dropout(self.conv31(net22), dropout_generator)
        net32 = self.dropout(self.conv32(net31), dropout_generator)
        net33 = self.conv33(net32)
        logits = self.fc(net33.permute(0, 2, 3, 1).reshape(net33.shape[0], -1))
        return ModelOutput(y_conv=logits, image_output=None, image_original=None, histograms={})


@register_model("CONCNNModel")
class CONCNNModel(NNModel):
    def default_params(self) -> Dict[str, Any]:
        return dict(DEFAULT_PARAMS)

    def create_module(self, class_count: int, algorithm_params: Dict[str, Any],
                      data_shape: Sequence[int]) -> CONCNNModule:
        return CONCNNModule(class_count, {**DEFAULT_PARAMS, **algorithm_params}, data_shape)

    def loss(self, output: ModelOutput, labels_onehot: torch.Tensor) -> torch.Tensor:
        return softmax_cross_entropy(output.y_conv, labels_onehot)
