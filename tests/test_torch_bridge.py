"""The flax -> torch weight bridge on a JAX ``train=True`` init of HYPELCNN
(filter_count 32, 12 bands plus LiDAR, 5 classes). Exact: the bridge copies
and transposes, it does no arithmetic."""

import copy

import jax
import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.compat.flax_to_torch import load_flax_variables, variables_to_state_dict
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from torch_parity import init_jax_hypelcnn

CLASSES = 5
PARAMS = {"filter_count": 32}
DATA_SHAPE = (3, 3, 13)


@pytest.fixture(scope="module")
def flax_variables():
    _, flax_params, batch_stats = init_jax_hypelcnn(CLASSES, PARAMS, DATA_SHAPE)
    return flax_params, batch_stats


def _port_module():
    return HYPELCNNModel().create_module(CLASSES, PARAMS, DATA_SHAPE)


def test_every_leaf_maps_exactly_once(flax_variables):
    flax_params, batch_stats = flax_variables
    n_leaves = len(jax.tree_util.tree_leaves(flax_params)) + \
        len(jax.tree_util.tree_leaves(batch_stats))
    state = variables_to_state_dict(flax_params, batch_stats)
    assert len(state) == n_leaves
    assert set(state) == set(_port_module().state_dict())
    assert "image_gen_net_4.Dense_0.weight" in state


def test_kernels_are_transposed(flax_variables):
    flax_params, batch_stats = flax_variables
    state = variables_to_state_dict(flax_params, batch_stats)
    hwio = flax_params["connector_0_conv3x3"]["Conv_0"]["kernel"]
    np.testing.assert_array_equal(state["connector_0_conv3x3.Conv_0.weight"].numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    dense = flax_params["fc_final"]["Dense_0"]["kernel"]
    np.testing.assert_array_equal(state["fc_final.Dense_0.weight"].numpy(), dense.T)
    np.testing.assert_array_equal(state["conv_enc_1.BatchNorm_0.var"].numpy(),
                                  batch_stats["conv_enc_1"]["BatchNorm_0"]["var"])
    np.testing.assert_array_equal(state["fc_final.BatchNorm_0.bias"].numpy(),
                                  flax_params["fc_final"]["BatchNorm_0"]["bias"])


def test_strict_load(flax_variables):
    module = _port_module()
    load_flax_variables(module, *flax_variables)
    for name, value in variables_to_state_dict(*flax_variables).items():
        assert torch.equal(module.state_dict()[name], value)


def test_extra_layer_raises(flax_variables):
    flax_params, batch_stats = copy.deepcopy(flax_variables)
    flax_params["fc_extra"] = {"Dense_0": {"kernel": np.zeros((4, 4), np.float32)}}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_variables(_port_module(), flax_params, batch_stats)


def test_unknown_leaf_raises(flax_variables):
    flax_params, batch_stats = copy.deepcopy(flax_variables)
    flax_params["fc_final"]["BatchNorm_0"]["scale"] = np.ones((CLASSES,), np.float32)
    with pytest.raises(KeyError, match="no mapping"):
        variables_to_state_dict(flax_params, batch_stats)


def test_missing_leaf_raises(flax_variables):
    flax_params, batch_stats = copy.deepcopy(flax_variables)
    del batch_stats["conv_dec_2"]["BatchNorm_0"]["mean"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_variables(_port_module(), flax_params, batch_stats)


def test_wrong_shape_raises(flax_variables):
    flax_params, batch_stats = copy.deepcopy(flax_variables)
    flax_params["conv_enc_0"]["Conv_0"]["kernel"] = np.zeros((1, 1, 12, 8), np.float32)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_flax_variables(_port_module(), flax_params, batch_stats)
