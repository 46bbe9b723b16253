"""``compute_dtype: "bfloat16"``, ``remat`` and ``predict_full_scene_scan`` in
the PyTorch port, on the CPU.

bfloat16 against the JAX package in bfloat16, from the same weights
(``tests/torch_parity.py``: the flax init with random batch-norm state) on
the same windows, train and eval mode, dropout off. The port rounds where
the JAX package rounds: a Python scalar (leaky ReLU's slope, batch norm's
epsilon, dropout's scale) is rounded to bfloat16 before it is applied, the
reciprocal root of batch norm is rounded once from float32, and CONCNN's
local response normalization sums its channel window as XLA does. So the
logits agree but for float32 rounding in the float32 heads: every logit
within ``LIMITS`` of the largest JAX logit's magnitude. Measured: 0
(HYPELCNN, fused or not), 3.4e-7 (CONCNN), 7.5e-7 (DUALCNN), and 2.7e-4 for
DUALCNN with fused levels, whose one 5x5 convolution sums its 1,600 terms in
another float32 order than XLA's, which turns a few bfloat16 roundings by
one unit. JAX's own bfloat16 logits are 1.5 to 1.9% (HYPELCNN), 0.70%
(CONCNN), 0.36% and 0.25% (DUALCNN) from its float32 ones, so a port that
ignored the key fails every limit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu_torch.core.registry import get_importer_from_name, get_model_from_name
from hypelcnn_tpu_torch.data.augmentation import AugmentationInfo
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.infer.scene_inference import predict_full_scene, predict_full_scene_scan
from hypelcnn_tpu_torch.train.trainer import ClassificationTrainer
from torch_parity import init_jax, torch_module
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SPEC = "synthetic://?h=48&w=64&bands=12&classes=5&seed=3"
CLASSES, CHANNELS, BATCH = 5, 13, 17
BF16 = {"compute_dtype": "bfloat16"}
CAP = {"feature_count": 16, "primary_capsule_count": 4}
SWEEP_AGREEMENT = 0.98
LIMITS = {"hypelcnn": 1e-5, "hypelcnn-fused": 1e-5, "concnn": 1e-5, "dualcnn": 1e-5,
          "dualcnn-fused": 1e-3}


def _jax_logits(jax_module, flax_params, batch_stats, x, labels, train):
    variables = {"params": flax_params, "batch_stats": batch_stats}
    if train:
        out, _ = jax_module.apply(variables, jnp.asarray(x), labels=jnp.asarray(labels),
                                  train=True, mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
    else:
        out = jax_module.apply(variables, jnp.asarray(x), train=False)
    return np.asarray(out.y_conv)


@pytest.mark.parametrize("case, model_name, params, patch", [
    ("hypelcnn", "HYPELCNNModel", {"filter_count": 32, "drop_out_ratio": 0.0}, 3),
    ("hypelcnn-fused", "HYPELCNNModel",
     {"filter_count": 32, "drop_out_ratio": 0.0, "fuse_level_convs": True}, 3),
    ("concnn", "CONCNNModel", {"filter_count": 16, "drop_out_ratio": 1.0}, 3),
    ("dualcnn", "DUALCNNModel", {"filter_count": 32, "drop_out_ratio": 1.0}, 5),
    ("dualcnn-fused", "DUALCNNModel",
     {"filter_count": 32, "drop_out_ratio": 1.0, "fuse_level_convs": True}, 5),
], ids=["hypelcnn", "hypelcnn-fused", "concnn", "dualcnn", "dualcnn-fused"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bfloat16_logits_match_jax(case, model_name, params, patch, train):
    params = {**params, **BF16}
    data_shape = (patch, patch, CHANNELS)
    jax_module, flax_params, batch_stats = init_jax(model_name, CLASSES, params, data_shape)
    x = np.random.default_rng(1).uniform(0, 1, (BATCH, patch, patch, CHANNELS)) \
        .astype(np.float32)
    labels = np.eye(CLASSES, dtype=np.float32)[np.arange(BATCH) % CLASSES]
    expected = _jax_logits(jax_module, flax_params, batch_stats, x, labels, train)
    module = torch_module(model_name, flax_params, batch_stats, CLASSES, params, data_shape)
    module.train(train)
    with torch.no_grad():
        out = module(torch.from_numpy(x), labels=torch.from_numpy(labels))
    got = out.y_conv
    assert got.dtype == torch.float32 and got.shape == (BATCH, CLASSES)
    if train and out.image_output is not None:
        assert out.image_output.dtype == torch.float32
    assert np.abs(got.numpy() - expected).max() <= LIMITS[case] * np.abs(expected).max()
    assert all(p.dtype == torch.float32 for p in module.state_dict().values())


@pytest.mark.parametrize("channels", [12, 48, 200])
def test_bfloat16_local_response_normalization_is_jax_bit_for_bit(channels):
    """Wider than one block of XLA's window sum (16 channels) and not a multiple of it."""
    from hypelcnn_tpu.ops.nn import local_response_normalization as jax_lrn
    from hypelcnn_tpu_torch.ops.nn import local_response_normalization

    x = np.random.default_rng(channels).normal(0, 1, (6, 3, channels)).astype(np.float32)
    expected = np.asarray(jax_lrn(jnp.asarray(x).astype(jnp.bfloat16)).astype(jnp.float32))
    got = local_response_normalization(torch.from_numpy(x).bfloat16(), dim=-1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), expected)


def _trainer(model_name, params, **kw):
    np.random.seed(0)
    data = get_importer_from_name("GeneratorImporter").read_data_set(
        "SyntheticDataLoader", SPEC, train_ratio=0.5, test_ratio=0.1, neighborhood=1)
    model = get_model_from_name(model_name)
    return ClassificationTrainer(
        model=model, class_count=data.class_count,
        algorithm_params={**model.default_params(), **params}, scene=data.scene,
        sample_set=data.sample_set, sources=data.sources, data_shape=data.data_shape,
        device="cpu", **kw)


def _steps(trainer, steps=2):
    state = trainer.init_state()
    tables = trainer.training_tables(steps, 16)
    losses = [trainer.train_step(state, tables, step) for step in range(steps)]
    grads = {n: p.grad.clone() for n, p in state.module.named_parameters() if p.grad is not None}
    return losses, state.module.state_dict(), grads


def test_bfloat16_training_keeps_float32_state():
    losses, state, _ = _steps(_trainer("HYPELCNNModel", {"filter_count": 32, **BF16}), 3)
    assert all(loss.dtype == torch.float32 and torch.isfinite(loss) for loss in losses)
    assert all(v.dtype == torch.float32 for v in state.values())
    fresh = _trainer("HYPELCNNModel", {"filter_count": 32, **BF16}).init_state().module
    assert not torch.equal(state["conv_enc_0.BatchNorm_0.mean"],
                           fresh.state_dict()["conv_enc_0.BatchNorm_0.mean"])


def test_cap_computes_in_float32_under_the_key():
    """CAP accepts the key and ignores it, as the JAX package does."""
    plain, plain_state, _ = _steps(_trainer("CAPModel", CAP))
    keyed, keyed_state, _ = _steps(_trainer("CAPModel", {**CAP, **BF16}))
    assert [float(v) for v in keyed] == [float(v) for v in plain]
    for key, value in plain_state.items():
        assert torch.equal(keyed_state[key], value), key


def test_float32_is_the_default():
    default, default_state, _ = _steps(_trainer("HYPELCNNModel", {"filter_count": 32}))
    explicit, explicit_state, _ = _steps(_trainer("HYPELCNNModel", {
        "filter_count": 32, "compute_dtype": "float32"}))
    assert [float(v) for v in explicit] == [float(v) for v in default]
    for key, value in default_state.items():
        assert torch.equal(explicit_state[key], value), key


def test_an_unknown_compute_dtype_is_an_error():
    with pytest.raises(ValueError, match="compute_dtype"):
        get_model_from_name("CONCNNModel").create_module(
            CLASSES, {**get_model_from_name("CONCNNModel").default_params(),
                      "compute_dtype": "float16"}, (3, 3, CHANNELS))


@pytest.mark.parametrize("model_name, params", [
    ("HYPELCNNModel", {"filter_count": 32, "drop_out_ratio": 0.5}),
    ("CAPModel", CAP),
], ids=["hypelcnn", "cap"])
def test_remat_gives_the_same_loss_and_gradients(model_name, params):
    """With dropout and augmentation on: the recomputed forward draws the
    same masks and moves no batch-norm statistic a second time."""
    augmentation = AugmentationInfo(perform_rotation_augmentation=True,
                                    perform_reflection_augmentation=True,
                                    perform_spectral_augmentation=0.05)
    plain = _steps(_trainer(model_name, params, augmentation_info=augmentation))
    remat = _steps(_trainer(model_name, {**params, "remat": True},
                            augmentation_info=augmentation))
    assert [float(v) for v in remat[0]] == [float(v) for v in plain[0]]
    for key, value in plain[2].items():
        assert torch.equal(remat[2][key], value), key
    for key, value in plain[1].items():
        assert torch.equal(remat[1][key], value), key


def test_scan_sweep_is_the_band_sweep():
    """CAP, whose map depends on each band's batch statistics."""
    scene = SyntheticDataLoader(SPEC).load_data(1, True)
    _, flax_params, batch_stats = init_jax("CAPModel", CLASSES, CAP, (3, 3, CHANNELS), seed=5)
    module = torch_module("CAPModel", flax_params, batch_stats, CLASSES, CAP, (3, 3, CHANNELS))
    swept = predict_full_scene(module, scene, batch_rows=5, device="cpu")
    assert len(np.unique(swept)) > 1
    np.testing.assert_array_equal(
        predict_full_scene_scan(module, scene, batch_rows=5, device="cpu"), swept)


def test_bfloat16_sweep_agrees_with_float32():
    """A trained HYPELCNN swept in bfloat16 and in float32: the share of
    pixels whose class agrees, at least SWEEP_AGREEMENT (measured 0.9935;
    chip_smoke.py's ``bf16`` phase holds the card to the same threshold)."""
    trainer = _trainer("HYPELCNNModel", {"filter_count": 32})
    result = trainer.fit(200, 16, log_every=100)
    state = result.final_state.module.state_dict()
    f32 = predict_full_scene(result.final_state.module, trainer.scene, device="cpu")
    model = get_model_from_name("HYPELCNNModel")
    module = model.create_module(CLASSES, {**model.default_params(), "filter_count": 32, **BF16},
                                 trainer.data_shape)
    module.load_state_dict(state)
    bf16 = predict_full_scene(module, trainer.scene, device="cpu")
    assert len(np.unique(f32)) == CLASSES
    assert (bf16 == f32).mean() >= SWEEP_AGREEMENT
