"""Shared set-up of the PyTorch-port parity tests (``test_torch_*.py``).

A flax module of any family is initialized in the JAX package with
``train=True`` and labels (so the train-only heads exist, HYPELCNN's
``image_gen`` and CAP's decoder, as in a trained checkpoint); its batch-norm
statistics and biases are then drawn from a numpy generator, so that
evaluation exercises the batch norm. Both frameworks get the same numpy
arrays, and the port's module loads them through the weight bridge.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from hypelcnn_tpu.core.registry import get_model_from_name as jax_get_model
from hypelcnn_tpu_torch.compat.flax_to_torch import load_flax_variables
from hypelcnn_tpu_torch.core.registry import get_model_from_name
from hypelcnn_tpu_torch.train.checkpoint import save_checkpoint
from hypelcnn_tpu_torch.train.optimizer import build_optimizer
from hypelcnn_tpu_torch.train.state import TrainState


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def init_jax(model_name: str, class_count: int, params: dict, data_shape, seed: int = 0):
    """``(flax module, params, batch_stats)`` with numpy leaves and random BN state."""
    module = jax_get_model(model_name).create_module(class_count, params)
    dummy = jnp.zeros((2, *data_shape), dtype=jnp.float32)
    labels = jnp.eye(class_count, dtype=jnp.float32)[jnp.arange(2) % class_count]
    variables = jax.jit(lambda rngs: module.init(rngs, dummy, labels=labels, train=True))(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)})
    flax_params = numpy_tree(variables["params"])
    batch_stats = numpy_tree(variables.get("batch_stats", {}))
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


def torch_module(model_name: str, flax_params, batch_stats, class_count: int, params: dict,
                 data_shape):
    """The port's module of ``model_name`` in eval mode, loaded strictly
    from the flax variables."""
    model = get_model_from_name(model_name)
    module = model.create_module(class_count, {**model.default_params(), **params}, data_shape)
    load_flax_variables(module, flax_params, batch_stats)
    return module.eval()


def save_module(log_dir, step: int, module, model_name: str = "HYPELCNNModel") -> str:
    """Save ``module`` as the training state at ``step`` of a run with the
    family's default Adam, whose moments are not made yet (zero, as optax
    starts them): an orbax step the port and the JAX package both read."""
    optimizer, schedule = build_optimizer(get_model_from_name(model_name).default_params(),
                                          module.parameters())
    state = TrainState(step=step, module=module, optimizer=optimizer, schedule=schedule)
    return save_checkpoint(str(log_dir), state.checkpoint_tree())
