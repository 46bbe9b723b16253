"""The training runtime of the PyTorch port against the JAX package: metrics,
the learning-rate schedule, the optimizers, the loss, checkpoints, random
streams and dropout.

Tolerances: the confusion matrix is exact and the metrics agree to 1e-12
(the same float64 numpy code). The schedule agrees to 1e-6 relative: optax
evaluates ``decay ** floor(count / steps)`` in float32, the port in float64.
Adam and Momentum agree to 1e-6 relative over 5 updates, relative to each
tensor's largest magnitude: the same update, rounded in another order.
Elementwise relative error is no measure here, because parameters that an
update brings near 0 keep the absolute rounding error of their start, and
optax computes Adam's ``1 - 0.999**t`` in float32 (1.3e-5 off at t = 1).
The loss agrees to 1e-6 relative on the same model outputs.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hypelcnn_tpu.core.rng import RngPool as JaxRngPool
from hypelcnn_tpu.models.base import ModelOutput as JaxModelOutput
from hypelcnn_tpu.models.hypelcnn import HYPELCNNModel as JaxHYPELCNNModel
from hypelcnn_tpu.train import metrics as jax_metrics
from hypelcnn_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from hypelcnn_tpu.train.optimizer import build_schedule as jax_build_schedule
from hypelcnn_tpu_torch.core.rng import RngPool
from hypelcnn_tpu_torch.models.base import ModelOutput
from hypelcnn_tpu_torch.models.hypelcnn import Dropout, HYPELCNNModel
from hypelcnn_tpu_torch.train import metrics
from hypelcnn_tpu_torch.train.checkpoint import (
    MAX_TO_KEEP,
    checkpoint_steps,
    restore_checkpoint,
    save_checkpoint,
)
from hypelcnn_tpu_torch.train.optimizer import build_optimizer, build_schedule
from hypelcnn_tpu_torch.train.state import TrainState
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SCHEDULE = {"learning_rate": 3e-4, "learning_rate_decay_factor": 0.96,
            "learning_rate_decay_step": 350}


def test_confusion_update_matches_jax():
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 6, 500).astype(np.int32)
    preds = rng.integers(0, 6, 500).astype(np.int32)
    mask = (rng.random(500) < 0.8).astype(np.int32)
    confusion = torch.zeros((6, 6), dtype=torch.int64)
    for sl in (slice(0, 300), slice(300, 500)):
        metrics.confusion_update(confusion, torch.from_numpy(labels[sl]),
                                 torch.from_numpy(preds[sl]), torch.from_numpy(mask[sl]))
    expected = jax_metrics.confusion_update(jnp.zeros((6, 6), jnp.int32), jnp.asarray(labels),
                                            jnp.asarray(preds), jnp.asarray(mask))
    np.testing.assert_array_equal(confusion.numpy(), np.asarray(expected))
    unmasked = metrics.confusion_update(torch.zeros((6, 6), dtype=torch.int64),
                                        torch.from_numpy(labels), torch.from_numpy(preds))
    assert int(unmasked.sum()) == 500


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_metrics_matches_jax(seed):
    rng = np.random.default_rng(seed)
    confusion = rng.integers(0, 50, (5, 5))
    confusion[seed] = 0  # an absent class
    got, expected = metrics.compute_metrics(confusion), jax_metrics.compute_metrics(confusion)
    for name in ("overall_accuracy", "mean_per_class_accuracy", "kappa"):
        assert getattr(got, name) == pytest.approx(getattr(expected, name), rel=1e-12, abs=1e-12)
    for name in ("confusion", "class_recall", "class_precision"):
        np.testing.assert_allclose(getattr(got, name), getattr(expected, name), rtol=1e-12)
    assert metrics.compute_metrics(np.zeros((3, 3))).overall_accuracy == 0.0


def test_schedule_matches_optax():
    ours, theirs = build_schedule(SCHEDULE), jax_build_schedule(SCHEDULE)
    for step in (0, 1, 349, 350, 351, 700, 701):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-6)
    assert ours(349) == SCHEDULE["learning_rate"]
    assert ours(350) == pytest.approx(SCHEDULE["learning_rate"] * 0.96)


@pytest.mark.parametrize("optimizer", ["AdamOptimizer", ["MomentumOptimizer", 0.9]])
def test_optimizer_matches_optax(optimizer):
    # decay every 2 updates, so the staircase turns inside the 5 updates
    params = {"learning_rate": 0.05, "learning_rate_decay_factor": 0.5,
              "learning_rate_decay_step": 2, "optimizer": optimizer}
    rng = np.random.default_rng(0)
    init = [rng.normal(size=shape).astype(np.float32) for shape in ((4, 3), (7,))]
    grads = [[rng.normal(size=p.shape).astype(np.float32) for p in init] for _ in range(5)]

    tx, _ = jax_build_optimizer(params)
    jparams = [jnp.asarray(p) for p in init]
    opt_state = tx.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in init]
    opt, schedule = build_optimizer(params, tparams)
    state = TrainState(step=0, module=torch.nn.Module(), optimizer=opt, schedule=schedule)
    for step_grads in grads:
        updates, opt_state = tx.update([jnp.asarray(g) for g in step_grads], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(tparams, step_grads):
            p.grad = torch.from_numpy(g)
        state.apply_gradients()
        for ours, theirs in zip(tparams, jparams):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(ours.detach().numpy(), theirs, rtol=0,
                                       atol=1e-6 * float(np.abs(theirs).max()))
    assert state.step == 5


@pytest.mark.parametrize("train", [True, False])
def test_hypelcnn_loss_matches_jax(train):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(8, 5)).astype(np.float32)
    onehot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 8)]
    original = rng.uniform(size=(8, 3, 3, 4)).astype(np.float32)
    image = rng.uniform(size=(8, 36)).astype(np.float32) if train else None
    expected = JaxHYPELCNNModel().loss(
        JaxModelOutput(jnp.asarray(logits), None if image is None else jnp.asarray(image),
                       jnp.asarray(original), {}), jnp.asarray(onehot))
    got = HYPELCNNModel().loss(
        ModelOutput(torch.from_numpy(logits), None if image is None else torch.from_numpy(image),
                    torch.from_numpy(original), {}), torch.from_numpy(onehot))
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=1e-6)


def test_rng_pool_streams():
    pool = RngPool(1234)
    for purpose in ("epoch-shuffle", "x"):
        np.testing.assert_array_equal(pool.numpy_rng(purpose).permutation(50),
                                      JaxRngPool(1234).numpy_rng(purpose).permutation(50))
    first = torch.rand(4, generator=pool.generator("dropout", 7))
    torch.rand(4, generator=pool.generator("augment", 3))
    torch.rand(4, generator=pool.generator("dropout", 8))
    # the same (seed, purpose, step) draws the same, whatever came before
    assert torch.equal(torch.rand(4, generator=pool.generator("dropout", 7)), first)
    assert torch.equal(torch.rand(4, generator=RngPool(1234).generator("dropout", 7)), first)
    assert not torch.equal(torch.rand(4, generator=pool.generator("dropout", 8)), first)
    assert not torch.equal(torch.rand(4, generator=RngPool(99).generator("dropout", 7)), first)


def test_dropout_draws_from_its_generator_only():
    x = torch.ones(2000, 10)
    layer = Dropout(0.7)
    a = layer(x, torch.Generator().manual_seed(3))
    torch.manual_seed(0)
    b = layer(x, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.28 < float(kept.float().mean()) < 0.32
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / 0.3))
    with pytest.raises(ValueError, match="generator"):
        layer(x, None)
    assert layer.eval()(x, None) is x


class _Dense(torch.nn.Module):
    """One dense layer under its flax name, so that its state has a JAX tree."""

    def __init__(self):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(3, 2)

    def forward(self, x):
        return self.Dense_0(x)


def _state(params):
    module = _Dense()
    optimizer, schedule = build_optimizer(params, module.parameters())
    return TrainState(step=0, module=module, optimizer=optimizer, schedule=schedule)


def test_checkpoint_restores_optimizer_and_schedule_across_the_decay(tmp_path):
    params = dict(SCHEDULE, optimizer="AdamOptimizer")
    state = _state(params)
    state.step = 348
    for _ in range(2):  # updates 349 and 350 in the schedule's count
        state.module(torch.ones(4, 3)).sum().backward()
        state.apply_gradients()
    assert state.step == 350
    save_checkpoint(str(tmp_path), state.checkpoint_tree())

    resumed = _state(params)
    resumed.restore(restore_checkpoint(str(tmp_path)))
    assert resumed.step == 350
    assert resumed.learning_rate() == pytest.approx(3e-4 * 0.96)
    for a, b in zip(resumed.module.parameters(), state.module.parameters()):
        assert torch.equal(a, b)
    for key, value in state.optimizer.state_dict()["state"][0].items():
        assert torch.equal(resumed.optimizer.state_dict()["state"][0][key], value)
    for s in (state, resumed):  # the next update is the same
        s.optimizer.zero_grad()
        s.module(torch.ones(4, 3)).sum().backward()
        s.apply_gradients()
    for a, b in zip(resumed.module.parameters(), state.module.parameters()):
        assert torch.equal(a, b)


def test_checkpoints_keep_the_newest_twenty(tmp_path):
    state = _state(dict(SCHEDULE, optimizer="AdamOptimizer"))
    for step in range(1, MAX_TO_KEEP + 3):
        state.step = step
        with torch.no_grad():
            state.module.Dense_0.bias.fill_(float(step))
        save_checkpoint(str(tmp_path), state.checkpoint_tree())
    assert checkpoint_steps(str(tmp_path)) == list(range(3, MAX_TO_KEEP + 3))
    latest = restore_checkpoint(str(tmp_path))
    assert latest["step"] == MAX_TO_KEEP + 2
    assert torch.equal(latest["state_dict"]["Dense_0.bias"],
                       torch.full((2,), float(MAX_TO_KEEP + 2)))
