"""HYPELCNN, the spectral/spatial multi-scale CNN (``hypelcnn_tpu/models/hypelcnn.py``).

- spectral encoder/decoder stacks of 1x1 convolutions with filter doubling /
  halving and residual adds through the channel shape-matcher;
- hierarchical spatial levels: parallel odd k x k SAME convolutions
  concatenated, a 1x1 connector conv, residual adds;
- a log-scaled fully connected pyramid with dropout (rate ``drop_out_ratio``);
- a batch-normalized logit head without activation;
- image-reconstruction heads ``image_gen_net_1..4`` that run only in train
  mode. They are built always, because a trained checkpoint holds them.

The public forward takes and returns NHWC, as the JAX module does; inside,
activations are NCHW views for ``nn.Conv2d``. The flatten before the FC
pyramid is in HWC order, as in JAX (an NCHW flatten would permute ``fc_0``).
The layer names and widths are those of the flax module, so its variables
load by name.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Sequence

import torch
from torch import nn

from hypelcnn_tpu_torch.core.registry import register_model
from hypelcnn_tpu_torch.models.base import ModelOutput, NNModel
from hypelcnn_tpu_torch.models.layers import SlimConv, SlimDense, multi_scale_level
from hypelcnn_tpu_torch.ops.nn import leaky_relu, scale_in_to_out

DEFAULT_PARAMS: Dict[str, Any] = {
    # matches configs/modelconfigs/alg_param_hypelcnn.json
    "batch_size": 48,
    "drop_out_ratio": 0.70,
    "filter_count": 480,
    "learning_rate": 3e-4,
    "learning_rate_decay_factor": 0.96,
    "learning_rate_decay_step": 350,
    "lrelu_alpha": 0.18,
    "optimizer": "AdamOptimizer",
    "bn_decay": 0.95,
    "l2regularizer_scale": 1e-5,
    "spectral_hierarchy_level": 3,
    "spatial_hierarchy_level": 3,
    "degradation_coeff": 3,
    "use_residual": True,
    "compute_dtype": "float32",
}


class HYPELCNNModule(nn.Module):
    def __init__(self, class_count: int, params_dict: Dict[str, Any], data_shape: Sequence[int]):
        super().__init__()
        p = params_dict
        if p.get("compute_dtype", "float32") != "float32":
            raise NotImplementedError("the port computes HYPELCNN in float32 only")
        if p.get("fuse_level_convs", False):
            raise NotImplementedError("fuse_level_convs is not ported yet (ROADMAP.md A9)")
        patch, patch_w, in_channels = data_shape
        if patch != patch_w:
            raise ValueError(f"HYPELCNN takes square patches, got {list(data_shape)}")
        self.use_residual = p["use_residual"]
        act = functools.partial(leaky_relu, alpha=p["lrelu_alpha"])

        def conv(cin: int, features: int, kernel: int) -> SlimConv:
            return SlimConv(cin, features, kernel, activation=act, use_batch_norm=True,
                            bn_momentum=p["bn_decay"])

        def dense(cin: int, features: int, activation=act) -> SlimDense:
            return SlimDense(cin, features, activation=activation, use_batch_norm=True,
                             bn_momentum=p["bn_decay"])

        count = p["spectral_hierarchy_level"]
        filters = p["filter_count"]
        width = in_channels
        self.encoder = []
        for i in range(count):
            feat = filters // (2 ** ((count - 1) - i))
            self.encoder.append(self._add(f"conv_enc_{i}", conv(width, feat, 1)))
            width = feat
        self.decoder = []
        for i in range(count):
            feat = filters // (2 ** i)
            self.decoder.append(self._add(f"conv_dec_{i}", conv(width, feat, 1)))
            width = feat

        level_filters = width // 2
        kernel_sizes = range(1, patch + 1, 2)  # the odd sizes up to the patch
        self.levels = []
        for index in range(p["spatial_hierarchy_level"]):
            feat = level_filters // (2 ** index)
            if feat == 0:
                raise ValueError(
                    f"filter_count={filters} too small for "
                    f"spatial_hierarchy_level={p['spatial_hierarchy_level']} "
                    f"(level {index} would have 0 filters)")
            branches = [self._add(f"connector_{index}_conv{k}x{k}", conv(width, feat, k))
                        for k in kernel_sizes]
            width = feat * len(kernel_sizes)
            self.levels.append((branches, self._add(f"connector_conv_{index}",
                                                    conv(width, width, 1))))

        degradation = p["degradation_coeff"]
        flatten_size = patch * patch * width
        fc_stage_count = math.floor(math.log(flatten_size / class_count, degradation))
        element_size = flatten_size
        self.fc_stages = []
        for stage in range(fc_stage_count - 1):
            self.fc_stages.append(self._add(f"fc_{stage}",
                                            dense(element_size, element_size // degradation)))
            element_size = element_size // degradation
        self.dropout = nn.Dropout(p["drop_out_ratio"])
        self.fc_final = dense(element_size, class_count, activation=None)

        self.image_gen_net_1 = dense(class_count, class_count * 3)
        self.image_gen_net_2 = dense(class_count * 3, class_count * 9)
        self.image_gen_net_3 = dense(class_count * 9, class_count * 27)
        self.image_gen_net_4 = dense(class_count * 27, patch * patch * in_channels,
                                     activation=torch.sigmoid)

    def _add(self, name: str, layer: nn.Module) -> nn.Module:
        self.add_module(name, layer)
        return layer

    def _residual(self, inp: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        return out + scale_in_to_out(inp, out, dim=1) if self.use_residual else out

    def _spectral_stack(self, x: torch.Tensor, layers) -> torch.Tensor:
        for layer in layers:
            x = self._residual(x, layer(x))
        return x

    def _spatial_blocks(self, x: torch.Tensor) -> torch.Tensor:
        for branches, connector in self.levels:
            nxt = self._residual(x, multi_scale_level(x, branches))
            nxt_conv = connector(nxt)
            x = nxt_conv + nxt if self.use_residual else nxt_conv
        return x

    def forward(self, x: torch.Tensor, labels: torch.Tensor | None = None) -> ModelOutput:
        """``x``: NHWC float32 patches ``[B, k, k, C]``."""
        net0 = x.permute(0, 3, 1, 2)
        net1 = self._residual(net0, self._spectral_stack(net0, self.encoder))
        net2 = self._residual(net1, self._spectral_stack(net1, self.decoder))
        net3 = self._residual(net2, self._spatial_blocks(net2))
        net4 = net3.permute(0, 2, 3, 1).reshape(net3.shape[0], -1)

        net5 = net4
        for stage in self.fc_stages:
            net5 = self.dropout(stage(net5))
        net6 = self.fc_final(net5)

        image_gen = None
        if self.training:
            g = self.image_gen_net_3(self.image_gen_net_2(self.image_gen_net_1(net6)))
            image_gen = self.image_gen_net_4(g)

        def nhwc(t):
            return t.permute(0, 2, 3, 1)

        return ModelOutput(
            y_conv=net6, image_output=image_gen, image_original=x,
            histograms={"spectral_expansion": nhwc(net1), "spectral_reduction": nhwc(net2),
                        "spatial": nhwc(net3), "classification": net5})


@register_model("HYPELCNNModel")
class HYPELCNNModel(NNModel):
    def default_params(self) -> Dict[str, Any]:
        return dict(DEFAULT_PARAMS)

    def create_module(self, class_count: int, algorithm_params: Dict[str, Any],
                      data_shape: Sequence[int]) -> HYPELCNNModule:
        params = {**DEFAULT_PARAMS, **algorithm_params}
        return HYPELCNNModule(class_count, params, data_shape)
