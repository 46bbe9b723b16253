"""``fuse_level_convs``: a multi-scale level as one zero-padded ``k_max``
convolution, in HYPELCNN and DUALCNN.

- In the port, the fused module loaded with ``fuse_variables`` of an
  unfused module's weights gives the unfused logits (``rtol=1e-5``), in
  evaluation and in training, where the running statistics and the
  gradients of the branch kernels agree too.
- The port's fused module equals the JAX package's fused module on the
  weights of the JAX ``fuse_variables`` (``rtol=1e-4, atol=1e-5``).
"""

import numpy as np
import pytest
import torch

from hypelcnn_tpu.models.layers import fuse_variables as jax_fuse_variables
from hypelcnn_tpu_torch.core.registry import get_model_from_name
from hypelcnn_tpu_torch.models.layers import FusedMultiScaleLevel, fuse_variables, init_parameters
from torch_parity import init_jax, jax_eval_logits, torch_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CLASSES = 5
CHANNELS = 13
CASES = [("HYPELCNNModel", {"filter_count": 32, "drop_out_ratio": 0.0}, 5),
         ("DUALCNNModel", {"filter_count": 32, "drop_out_ratio": 1.0}, 5)]


def _pair(model_name, params, patch, seed=0):
    """An unfused module with random weights and batch-norm state, and the
    fused module loaded from it."""
    model = get_model_from_name(model_name)
    base = {**model.default_params(), **params}
    shape = (patch, patch, CHANNELS)
    unfused = model.create_module(CLASSES, base, shape)
    gen = torch.Generator().manual_seed(seed)
    init_parameters(unfused, gen)
    with torch.no_grad():
        for name, value in unfused.state_dict().items():
            if name.endswith(("BatchNorm_0.bias", "BatchNorm_0.mean")):
                value.copy_(0.1 * torch.randn(value.shape, generator=gen))
            elif name.endswith("BatchNorm_0.var"):
                value.copy_(torch.rand(value.shape, generator=gen) + 0.5)
    fused = model.create_module(CLASSES, {**base, "fuse_level_convs": True}, shape)
    fused.load_state_dict(fuse_variables(unfused.state_dict()), strict=True)
    return unfused, fused


@pytest.mark.parametrize("model_name, params, patch", CASES)
def test_fused_equals_unfused_in_the_port(model_name, params, patch):
    unfused, fused = _pair(model_name, params, patch)
    levels = [m for m in fused.modules() if isinstance(m, FusedMultiScaleLevel)]
    assert levels and all(m.kernel_sizes[-1] == 2 * len(m.kernel_sizes) - 1 for m in levels)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (16, patch, patch, CHANNELS))
                         .astype(np.float32))
    with torch.no_grad():
        expected = unfused.eval()(x).y_conv
        got = fused.eval()(x).y_conv
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-6)

    labels = torch.eye(CLASSES)[torch.arange(16) % CLASSES]
    for module in (unfused.train(), fused.train()):
        out = module(x, labels=labels)
        loss = torch.mean(get_model_from_name(model_name).loss(out, labels))
        loss.backward()
    torch.testing.assert_close(fused(x, labels=labels).y_conv.detach(),
                               unfused(x, labels=labels).y_conv.detach(), rtol=1e-5, atol=1e-6)
    stats = fuse_variables(unfused.state_dict())
    for key, value in fused.state_dict().items():
        torch.testing.assert_close(value, stats[key], rtol=1e-5, atol=1e-6, msg=key)
    grads = fuse_variables({k: p.grad for k, p in unfused.named_parameters()})
    for key, param in fused.named_parameters():
        scale = float(grads[key].abs().max())
        assert float((param.grad - grads[key]).abs().max()) <= 1e-4 * scale + 1e-9, key


@pytest.mark.parametrize("model_name, params, patch", CASES)
def test_port_fused_equals_jax_fused(model_name, params, patch):
    shape = (patch, patch, CHANNELS)
    fused_params = {**params, "fuse_level_convs": True}
    jax_fused, _, _ = init_jax(model_name, CLASSES, fused_params, shape)
    _, flax_params, batch_stats = init_jax(model_name, CLASSES, params, shape)
    variables = jax_fuse_variables({"params": flax_params, "batch_stats": batch_stats})
    params_f, stats_f = _numpy(variables["params"]), _numpy(variables["batch_stats"])
    x = np.random.default_rng(2).uniform(0, 1, (17, *shape)).astype(np.float32)
    expected = jax_eval_logits(jax_fused, params_f, stats_f, x)
    module = torch_module(model_name, params_f, stats_f, CLASSES, fused_params, shape)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).y_conv.numpy()
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), expected.argmax(1))


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_fuse_variables_merges_branches_in_ascending_k():
    state = {"a_conv3x3.Conv_0.weight": torch.ones(2, 1, 3, 3),
             "a_conv1x1.Conv_0.weight": torch.zeros(2, 1, 1, 1),
             "a_conv1x1.BatchNorm_0.mean": torch.tensor([1.0, 2.0]),
             "a_conv3x3.BatchNorm_0.mean": torch.tensor([3.0, 4.0]),
             "a_conv_0.Conv_0.weight": torch.ones(1)}
    fused = fuse_variables(state)
    assert sorted(fused) == ["a_conv_0.Conv_0.weight", "a_fused.BatchNorm_0.mean",
                             "a_fused.conv1x1_kernel", "a_fused.conv3x3_kernel"]
    assert fused["a_fused.BatchNorm_0.mean"].tolist() == [1.0, 2.0, 3.0, 4.0]
