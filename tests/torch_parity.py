"""Shared set-up of the PyTorch-port parity tests (``test_torch_*.py``).

One flax HYPELCNN is initialized in the JAX package with ``train=True`` (so
the ``image_gen`` heads exist, as in a trained checkpoint); its batch-norm
statistics and biases are then drawn from a numpy generator, so that
evaluation exercises the batch norm. Both frameworks get the same numpy
arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hypelcnn_tpu.models.hypelcnn import HYPELCNNModel as JaxHYPELCNNModel
from hypelcnn_tpu_torch.compat.flax_to_torch import load_flax_variables
from hypelcnn_tpu_torch.models.hypelcnn import HYPELCNNModel


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def init_jax_hypelcnn(class_count: int, params: dict, data_shape, seed: int = 0):
    """``(flax module, params, batch_stats)`` with numpy leaves and random BN state."""
    module = JaxHYPELCNNModel().create_module(class_count, params)
    dummy = jnp.zeros((2, *data_shape), dtype=jnp.float32)
    variables = jax.jit(lambda rngs: module.init(rngs, dummy, train=True))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)})
    flax_params = _numpy_tree(variables["params"])
    batch_stats = _numpy_tree(variables["batch_stats"])
    rng = np.random.default_rng(seed)

    def randomize(path, leaf):
        name = path[-1].key
        if name == "mean":
            return rng.normal(0.0, 0.5, leaf.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "bias":
            return rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
        return leaf

    batch_stats = jax.tree_util.tree_map_with_path(randomize, batch_stats)
    flax_params = jax.tree_util.tree_map_with_path(randomize, flax_params)
    return module, flax_params, batch_stats


def jax_eval_logits(module, flax_params, batch_stats, x: np.ndarray) -> np.ndarray:
    out = module.apply({"params": flax_params, "batch_stats": batch_stats},
                       jnp.asarray(x), train=False)
    return np.asarray(out.y_conv)


def torch_module_from(flax_params, batch_stats, class_count: int, params: dict, data_shape):
    """The port's HYPELCNN in eval mode, loaded strictly from the flax variables."""
    module = HYPELCNNModel().create_module(class_count, params, data_shape)
    load_flax_variables(module, flax_params, batch_stats)
    return module.eval()
