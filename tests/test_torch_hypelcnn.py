"""HYPELCNN in the PyTorch port against the JAX module on the same weights.

Tolerance: float32 logits within ``rtol=1e-4, atol=1e-5`` and equal argmax.
Both run float32 on the CPU; the two frameworks sum the convolutions in
different orders, so the logits agree to rounding, not bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.ops.nn import leaky_relu as jax_leaky_relu
from hypelcnn_tpu.ops.nn import scale_in_to_out as jax_scale_in_to_out
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel
from hypelcnn_tpu_torch.ops.nn import leaky_relu, scale_in_to_out
from torch_parity import init_jax_hypelcnn, jax_eval_logits, torch_module_from

CLASSES = 5
CHANNELS = 13  # 12 bands plus LiDAR


@pytest.mark.parametrize("patch, filter_count, use_residual", [
    (3, 128, True),   # 72 -> fc_0 -> 24 -> fc_final
    (3, 128, False),
    (5, 32, True),    # three branches per level; fc_0 75 -> 25
    (5, 32, False),
])
def test_eval_logits_match_jax(patch, filter_count, use_residual):
    params = {"filter_count": filter_count, "use_residual": use_residual}
    data_shape = (patch, patch, CHANNELS)
    jax_module, flax_params, batch_stats = init_jax_hypelcnn(CLASSES, params, data_shape)
    x = np.random.default_rng(1).uniform(0, 1, (17, *data_shape)).astype(np.float32)

    expected = jax_eval_logits(jax_module, flax_params, batch_stats, x)
    module = torch_module_from(flax_params, batch_stats, CLASSES, params, data_shape)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).y_conv.numpy()

    assert got.shape == (17, CLASSES)
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), expected.argmax(1))


def test_residual_widths_take_the_nearest_index_branch():
    # 13 input channels into the first encoder's filter_count // 4 outputs:
    # neither divides the other, so the residual gathers nearest channels
    module = HYPELCNNModel().create_module(CLASSES, {"filter_count": 32}, (3, 3, CHANNELS))
    assert module.conv_enc_0.Conv_0.out_channels == 8
    assert 8 % CHANNELS != 0


def test_train_mode_forward_matches_jax():
    """Train mode with dropout off: batch statistics, the running-stat
    update and the reconstruction heads agree with the JAX module."""
    params = {"filter_count": 32, "drop_out_ratio": 0.0}
    data_shape = (3, 3, CHANNELS)
    jax_module, flax_params, batch_stats = init_jax_hypelcnn(CLASSES, params, data_shape)
    x = np.random.default_rng(2).uniform(0, 1, (16, *data_shape)).astype(np.float32)
    out, updated = jax_module.apply({"params": flax_params, "batch_stats": batch_stats},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"])

    module = torch_module_from(flax_params, batch_stats, CLASSES, params, data_shape).train()
    with torch.no_grad():
        got = module(torch.from_numpy(x))

    np.testing.assert_allclose(got.y_conv.numpy(), np.asarray(out.y_conv), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.image_output.numpy(), np.asarray(out.image_output),
                               rtol=1e-4, atol=1e-5)
    state = module.state_dict()
    for path, leaf in jax.tree_util.tree_leaves_with_path(updated["batch_stats"]):
        key = ".".join(p.key for p in path)
        np.testing.assert_allclose(state[key].numpy(), np.asarray(leaf), rtol=1e-4, atol=1e-5)


def test_eval_mode_has_no_reconstruction_head():
    module = HYPELCNNModel().create_module(CLASSES, {"filter_count": 32}, (3, 3, CHANNELS)).eval()
    out = module(torch.zeros(2, 3, 3, CHANNELS))
    assert out.image_output is None
    assert out.histograms["spatial"].shape[:3] == (2, 3, 3)


@pytest.mark.parametrize("in_ch, out_ch", [(4, 4), (4, 8), (4, 12), (13, 8), (8, 13), (3, 7)])
def test_scale_in_to_out_matches_jax(in_ch, out_ch):
    """Exact: ``repeat_interleave`` repeats channels in place as ``jnp.repeat``
    does, and the nearest-index list is the same Python ``round``."""
    x = np.random.default_rng(0).normal(size=(2, 3, 3, in_ch)).astype(np.float32)
    expected = np.asarray(jax_scale_in_to_out(jnp.asarray(x), jnp.zeros((2, 3, 3, out_ch))))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = scale_in_to_out(nchw, torch.zeros(2, out_ch, 3, 3), dim=1).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), expected)


def test_leaky_relu_matches_jax_with_unit_gradient_at_zero():
    x = np.array([-2.0, -0.5, 0.0, 0.5, 3.0], dtype=np.float32)
    np.testing.assert_array_equal(leaky_relu(torch.from_numpy(x), 0.18).numpy(),
                                  np.asarray(jax_leaky_relu(jnp.asarray(x), 0.18)))
    zero = torch.zeros(1, requires_grad=True)
    leaky_relu(zero, 0.18).sum().backward()
    assert zero.grad.item() == 1.0
