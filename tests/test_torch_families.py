"""CONCNN, DUALCNN and CAP in the PyTorch port against the JAX package.

Small widths on the scene of ``tests/conftest.py``; weights go from the
flax init through the weight bridge, inputs are made with numpy.

Tolerances: float32 logits within ``rtol=1e-4, atol=1e-5`` with equal
argmax, and each gradient within 1e-4 of the tensor's largest magnitude.
Both frameworks run float32 on the CPU and sum the convolutions, the LRN's
cumulative sums and the capsule products in different orders, so they agree
to rounding, not bit for bit. CAP normalizes with batch statistics in
evaluation and routes with agreement summed over the batch: its tests feed
both frameworks the same batches.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hypelcnn_tpu.core.registry import get_importer_from_name as jax_get_importer
from hypelcnn_tpu.core.registry import get_model_from_name as jax_get_model
from hypelcnn_tpu.data.loaders.synthetic import SyntheticDataLoader as JaxSyntheticDataLoader
from hypelcnn_tpu.infer import scene_inference as jax_inference
from hypelcnn_tpu.ops.nn import local_response_normalization as jax_lrn
from hypelcnn_tpu.ops.nn import squash as jax_squash
from hypelcnn_tpu.parallel.mesh import create_mesh
from hypelcnn_tpu.train.trainer import ClassificationTrainer as JaxClassificationTrainer
from hypelcnn_tpu_torch.apps import infer_for_classification, train_for_classification
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_model_from_name
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene, predict_targets
from hypelcnn_tpu_torch.models.cap import margin_loss
from hypelcnn_tpu_torch.models.layers import SlimConv, SlimDense, init_parameters
from hypelcnn_tpu_torch.ops.nn import local_response_normalization, squash
from hypelcnn_tpu_torch.train.checkpoint import checkpoint_steps
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from torch_parity import init_jax, jax_eval_logits, numpy_tree, torch_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CLASSES = 5
CHANNELS = 13  # 12 bands plus LiDAR
CONCNN = {"filter_count": 16}
DUALCNN = {"filter_count": 32}
CAP = {"feature_count": 16, "primary_capsule_count": 4}


def _inputs(seed, batch, patch):
    return np.random.default_rng(seed).uniform(0, 1, (batch, patch, patch, CHANNELS)) \
        .astype(np.float32)


def _onehot(ids):
    return np.eye(CLASSES, dtype=np.float32)[ids]


@pytest.mark.parametrize("model_name, params, patch", [
    ("CONCNNModel", CONCNN, 3),
    ("CONCNNModel", CONCNN, 5),
    ("DUALCNNModel", DUALCNN, 1),   # no crop, one branch a level
    ("DUALCNNModel", DUALCNN, 3),   # the HSI crop leaves 1x1
    ("DUALCNNModel", DUALCNN, 5),   # 3x3 HSI levels, 5x5 LiDAR levels
    ("CAPModel", CAP, 1),
    ("CAPModel", CAP, 3),           # data_size 36
    ("CAPModel", {**CAP, "iter_routing": 1}, 3),  # the routing of a trained CAP point
])
def test_eval_logits_match_jax(model_name, params, patch):
    data_shape = (patch, patch, CHANNELS)
    jax_module, flax_params, batch_stats = init_jax(model_name, CLASSES, params, data_shape)
    x = _inputs(1, 17, patch)
    expected = jax_eval_logits(jax_module, flax_params, batch_stats, x)
    module = torch_module(model_name, flax_params, batch_stats, CLASSES, params, data_shape)
    with torch.no_grad():
        got = module(torch.from_numpy(x)).y_conv.numpy()
    assert got.shape == (17, CLASSES)
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(1), expected.argmax(1))


@pytest.mark.parametrize("model_name, params, patch", [
    ("CONCNNModel", {**CONCNN, "drop_out_ratio": 1.0}, 3),   # rate 1 - 1.0: dropout off
    ("DUALCNNModel", {**DUALCNN, "drop_out_ratio": 1.0}, 5),
    ("CAPModel", CAP, 3),
])
def test_train_mode_forward_and_gradients_match_jax(model_name, params, patch):
    """Logits, CAP's decoder output and running statistics, the loss and
    every parameter's gradient, in train mode with dropout off."""
    data_shape = (patch, patch, CHANNELS)
    jax_module, flax_params, batch_stats = init_jax(model_name, CLASSES, params, data_shape)
    x = _inputs(2, 16, patch)
    labels = _onehot(np.arange(16) % CLASSES)
    jax_model = jax_get_model(model_name)

    def loss_fn(p):
        out, updated = jax_module.apply(
            {"params": p, "batch_stats": batch_stats}, jnp.asarray(x),
            labels=jnp.asarray(labels), train=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(jax_model.loss(out, jnp.asarray(labels))), (out, updated)

    (jax_loss, (out, updated)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, flax_params))

    model = get_model_from_name(model_name)
    module = torch_module(model_name, flax_params, batch_stats, CLASSES, params, data_shape).train()
    got = module(torch.from_numpy(x), labels=torch.from_numpy(labels))
    loss = torch.mean(model.loss(got, torch.from_numpy(labels)))
    loss.backward()

    np.testing.assert_allclose(got.y_conv.detach().numpy(), np.asarray(out.y_conv),
                               rtol=1e-4, atol=1e-5)
    assert float(loss.detach()) == pytest.approx(float(jax_loss), rel=1e-5)
    if model_name == "CAPModel":
        np.testing.assert_allclose(got.image_output.detach().numpy(),
                                   np.asarray(out.image_output), rtol=1e-4, atol=1e-5)
        state = module.state_dict()
        stats = variables_to_state_dict({}, numpy_tree(updated["batch_stats"]))
        assert sorted(stats) == ["Conv1_layer.BatchNorm_0.mean", "Conv1_layer.BatchNorm_0.var",
                                 "PrimaryCaps_layer.BatchNorm_0.mean",
                                 "PrimaryCaps_layer.BatchNorm_0.var"]
        for key, value in stats.items():
            np.testing.assert_allclose(state[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-5,
                                       err_msg=key)
    else:
        assert got.image_output is None
    expected_grads = variables_to_state_dict(numpy_tree(grads))
    named = dict(module.named_parameters())
    assert sorted(named) == sorted(expected_grads)
    for key, theirs in expected_grads.items():
        ours = named[key].grad if named[key].grad is not None else torch.zeros_like(named[key])
        scale = float(theirs.abs().max())
        assert float((ours - theirs).abs().max()) <= 1e-4 * scale, (key, scale)


def test_cap_logits_depend_on_the_batch_as_in_jax():
    """The same window in two batches gets two sets of logits (batch-stat
    batch norm and batch-summed routing), in both frameworks alike; the
    running statistics do not move in evaluation."""
    data_shape = (3, 3, CHANNELS)
    jax_module, flax_params, batch_stats = init_jax("CAPModel", CLASSES, CAP, data_shape)
    module = torch_module("CAPModel", flax_params, batch_stats, CLASSES, CAP, data_shape)
    before = {k: v.clone() for k, v in module.state_dict().items()}
    x = _inputs(3, 16, 3)
    other = np.concatenate([x[:1], _inputs(4, 7, 3)])
    with torch.no_grad():
        first = module(torch.from_numpy(x)).y_conv.numpy()
        second = module(torch.from_numpy(other)).y_conv.numpy()
    assert np.abs(first[0] - second[0]).max() > 1e-3
    for batch, got in ((x, first), (other, second)):
        np.testing.assert_allclose(got, jax_eval_logits(jax_module, flax_params, batch_stats,
                                                        batch), rtol=1e-4, atol=1e-5)
    for key, value in module.state_dict().items():
        assert torch.equal(value, before[key]), key


def test_lrn_matches_jax_and_the_brute_force():
    x = np.random.default_rng(0).uniform(size=(2, 3, 3, 16)).astype(np.float32)
    got = local_response_normalization(torch.from_numpy(x).permute(0, 3, 1, 2)) \
        .permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_lrn(jnp.asarray(x))), rtol=1e-5, atol=1e-7)
    expected = np.empty_like(x)
    r, bias, alpha, beta = 5, 1.0, 1.0, 0.5
    for c in range(16):
        lo, hi = max(0, c - r), min(16, c + r + 1)
        s = (x[..., lo:hi] ** 2).sum(axis=-1)
        expected[..., c] = x[..., c] / np.power(bias + alpha * s, beta)
    np.testing.assert_allclose(got, expected, rtol=1e-5)
    # not torch's LRN, which averages over the window
    assert np.abs(torch.nn.functional.local_response_norm(
        torch.from_numpy(x).permute(0, 3, 1, 2), 11, alpha=1.0, beta=0.5, k=1.0)
        .permute(0, 2, 3, 1).numpy() - expected).max() > 1e-2


def test_squash_and_margin_loss_match_jax():
    from hypelcnn_tpu.models.cap import margin_loss as jax_margin_loss
    s = np.random.default_rng(1).normal(size=(4, 5, 16)).astype(np.float32)
    np.testing.assert_allclose(squash(torch.from_numpy(s)).numpy(),
                               np.asarray(jax_squash(jnp.asarray(s))), rtol=1e-6, atol=1e-7)
    v = squash(torch.tensor([[3.0, 4.0]])).numpy()
    norm_sq = (9 + 16) / 2  # the mean of squares, not the sum
    np.testing.assert_allclose(v, norm_sq / (1 + norm_sq) / np.sqrt(norm_sq) * np.array([[3, 4]]),
                               rtol=1e-6)
    logits = np.random.default_rng(2).uniform(0, 1, (6, CLASSES)).astype(np.float32)
    labels = _onehot(np.arange(6) % CLASSES)
    recon, original = (np.random.default_rng(3).uniform(size=shape).astype(np.float32)
                       for shape in ((6, 9 * CHANNELS), (6, 3, 3, CHANNELS)))
    got = margin_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.from_numpy(recon), torch.from_numpy(original))
    expected = jax_margin_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(recon),
                               jnp.asarray(original))
    assert float(got) == pytest.approx(float(expected), rel=1e-6)


@pytest.mark.parametrize("model_name, params, patch", [
    ("CONCNNModel", {"filter_count": 64}, 5),
    ("DUALCNNModel", {"filter_count": 128}, 5),
    ("CAPModel", {"feature_count": 64, "primary_capsule_count": 8}, 3),
])
def test_init_draws_xavier_per_layer(model_name, params, patch):
    """flax's ``xavier_uniform()``: uniform in +-sqrt(6 / (fan_in + fan_out)),
    std sqrt(2 / (fan_in + fan_out)), with receptive-field fans; CAP's
    capsule weight per capsule (fan-in pco, fan-out classes*dco)."""
    model = get_model_from_name(model_name)
    module = model.create_module(CLASSES, {**model.default_params(), **params},
                                 (patch, patch, CHANNELS))
    init_parameters(module, torch.Generator().manual_seed(0))
    checked = 0
    for name, layer in module.named_modules():
        if isinstance(layer, (SlimConv, SlimDense)):
            assert layer.kernel_init == "xavier", name
            weight = (layer.Conv_0 if isinstance(layer, SlimConv) else layer.Dense_0).weight
            receptive = weight[0, 0].numel()
            fan_in, fan_out = weight.shape[1] * receptive, weight.shape[0] * receptive
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            assert float(weight.detach().abs().max()) <= bound, name
            bias = (layer.Conv_0 if isinstance(layer, SlimConv) else layer.Dense_0).bias
            assert bias is None or not bias.any(), name
            if weight.numel() >= 4000:
                assert abs(float(weight.detach().std()) / (bound / np.sqrt(3.0)) - 1) < 0.1, name
                checked += 1
    assert checked >= 3
    if model_name == "CAPModel":
        w = module.digitcaps_w
        data_size, pco, out_dim = w.shape
        expected_std = np.sqrt(2.0 / (pco + out_dim))  # independent of data_size
        assert abs(float(w.detach().std()) / expected_std - 1) < 0.05
        assert not module.digitcaps_b.any()


def _port_data(neighborhood):
    np.random.seed(0)
    return get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=neighborhood)


@pytest.mark.parametrize("model_name, params", [
    ("CONCNNModel", {**CONCNN, "drop_out_ratio": 1.0}),                     # Momentum 0.9
    ("CAPModel", {**CAP, "learning_rate": 1e-3}),                           # Adam
])
def test_five_step_trajectory_matches_the_jax_trainer(model_name, params):
    """5 steps from the flax init on the same batches, augmentation and
    dropout off: the per-step losses agree to 1e-4 relative."""
    batch, steps = 16, 5
    algorithm_params = {**jax_get_model(model_name).default_params(), **params,
                        "batch_size": batch}
    np.random.seed(0)
    jax_data = jax_get_importer("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    jax_trainer = JaxClassificationTrainer(
        model=jax_get_model(model_name), class_count=jax_data.class_count,
        algorithm_params=algorithm_params, scene=jax_data.scene,
        sample_set=jax_data.sample_set, sources=jax_data.sources,
        data_shape=jax_data.data_shape, mesh=create_mesh())
    init = jax_trainer.init_state()
    init_state_dict = variables_to_state_dict(numpy_tree(init.params),
                                              numpy_tree(init.batch_stats))
    jax_losses = []
    jax_result = jax_trainer.fit(steps, batch, log_every=1,
                                 progress_callback=lambda s, l: jax_losses.append((s, l)))

    data = _port_data(1)
    trainer = ClassificationTrainer(
        model=get_model_from_name(model_name), class_count=data.class_count,
        algorithm_params=algorithm_params, scene=data.scene, sample_set=data.sample_set,
        sources=data.sources, data_shape=data.data_shape, device="cpu")
    losses = []
    result = trainer.fit(steps, batch, log_every=1, state_dict=init_state_dict,
                         progress_callback=lambda s, l: losses.append((s, l)))

    assert [s for s, _ in losses] == [s for s, _ in jax_losses] == list(range(1, steps + 1))
    np.testing.assert_allclose([l for _, l in losses], [l for _, l in jax_losses], rtol=1e-4)
    final = variables_to_state_dict(numpy_tree(jax_trainer.final_state.params),
                                    numpy_tree(jax_trainer.final_state.batch_stats))
    ours = result.final_state.module.state_dict()
    assert sorted(ours) == sorted(final)
    # as in test_torch_train_loop.py: Adam moves a weight whose gradient
    # rounds to either sign by up to 2 * lr a step the other way
    for key, theirs in final.items():
        np.testing.assert_allclose(ours[key].numpy(), theirs.numpy(), rtol=1e-3, atol=2e-3,
                                   err_msg=key)
        assert float((ours[key] - theirs).abs().mean()) < 2e-4, key
    assert result.test_accuracy == pytest.approx(jax_result.test_accuracy, abs=0.02)


def test_trainer_init_draws_the_capsule_weight():
    data = _port_data(1)
    trainer = ClassificationTrainer(
        model=get_model_from_name("CAPModel"), class_count=data.class_count,
        algorithm_params={**get_model_from_name("CAPModel").default_params(), **CAP},
        scene=data.scene, sample_set=data.sample_set, sources=data.sources,
        data_shape=data.data_shape, device="cpu")
    w = trainer.init_state().module.digitcaps_w.detach()
    assert abs(float(w.std()) / np.sqrt(2.0 / (w.shape[1] + w.shape[2])) - 1) < 0.1


@pytest.fixture(scope="module")
def cap_setup():
    data_shape = (3, 3, CHANNELS)
    jax_module, flax_params, batch_stats = init_jax("CAPModel", CLASSES, CAP, data_shape, seed=5)
    module = torch_module("CAPModel", flax_params, batch_stats, CLASSES, CAP, data_shape)
    variables = {"params": flax_params, "batch_stats": batch_stats}
    jax_scene = JaxSyntheticDataLoader(SPEC).load_data(1, True)
    scene = SyntheticDataLoader(SPEC).load_data(1, True)
    return jax_module, variables, jax_scene, module, scene


def test_cap_full_scene_map_matches_jax(cap_setup):
    jax_module, variables, jax_scene, module, scene = cap_setup
    expected = jax_inference.predict_full_scene(jax_module, variables, jax_scene, batch_rows=16)
    got = predict_full_scene(module, scene, batch_rows=16, device="cpu")
    assert len(np.unique(got)) > 1
    np.testing.assert_array_equal(got, expected)


def test_cap_predict_targets_pads_the_last_batch_as_jax_does(cap_setup):
    """150 targets in batches of 64: the last batch holds 22 targets and 42
    windows at (0, 0), whose batch statistics CAP's ids depend on."""
    jax_module, variables, jax_scene, module, scene = cap_setup
    rng = np.random.default_rng(0)
    targets = np.stack([rng.integers(0, 64, 150), rng.integers(0, 48, 150),
                        rng.integers(0, CLASSES, 150)], axis=1).astype(np.int32)
    expected = jax_inference.predict_targets(jax_module, variables, jax_scene, targets,
                                             batch_size=64)
    got = predict_targets(module, scene, targets, device="cpu", batch_size=64)
    assert got.shape == (150,) and len(np.unique(got)) > 1
    np.testing.assert_array_equal(got, expected)


@pytest.mark.parametrize("model_name, params, neighborhood", [
    ("CONCNNModel", CONCNN, 1),
    ("DUALCNNModel", DUALCNN, 2),
    ("CAPModel", CAP, 1),
])
def test_train_cli_then_infer_cli(tmp_path, model_name, params, neighborhood):
    params_path = tmp_path / "params.json"
    params_path.write_text(json.dumps(params))
    common = ["--loader_name=SyntheticDataLoader", f"--path={SPEC}",
              f"--neighborhood={neighborhood}", f"--algorithm_param_path={params_path}",
              f"--model_name={model_name}", "--device=cpu"]
    result = train_for_classification.main(common + [
        "--importer_name=GeneratorImporter", "--step=3", "--batch_size=8",
        "--save_checkpoint_steps=2", f"--base_log_path={tmp_path / 'log'}"])
    (log_dir,) = (tmp_path / "log").iterdir()
    patch = 2 * neighborhood + 1
    assert log_dir.name == (f"syntheticldr_{model_name.lower().replace('model', 'mdl')}"
                            f"_trn010_params_{patch}x{patch}")
    assert checkpoint_steps(str(log_dir)) == [2, 3]
    assert np.isfinite(result.loss)
    infer_for_classification.main(common + [f"--base_log_path={log_dir}",
                                            f"--output_path={tmp_path / 'out'}", "--domain=all"])
    scene = SyntheticDataLoader(SPEC).load_data(neighborhood, True)
    expected = predict_full_scene(result.final_state.module, scene, device="cpu")
    with Image.open(tmp_path / "out" / "result_raw.tif") as image:
        np.testing.assert_array_equal(np.asarray(image), expected)
