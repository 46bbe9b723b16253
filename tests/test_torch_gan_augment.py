"""GAN-augmented classification in the port against the JAX package on the
CPU: the shadow ops, ``augment_batch`` with an injected shadow draw, the
shadow creators restored at a loader's declared paths, and the train CLI's
``--augment_data_with_shadow`` through to the infer CLI. With shadow
augmentation off, the other draws are taken as they always were.

Tolerances: the simple ratio and every op around it bit for bit; the frozen
generator to ``rtol=1e-5, atol=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypelcnn_tpu.data import augmentation as jax_aug
from hypelcnn_tpu.gan import shadow_ops as jax_shadow_ops
from hypelcnn_tpu.gan.wrapper_registry import get_trainer_dict as jax_get_trainer_dict
from hypelcnn_tpu_torch.apps import gan_train_for_shadow, infer_for_classification
from hypelcnn_tpu_torch.apps import train_for_classification
from hypelcnn_tpu_torch.compat.flax_to_torch import variables_to_state_dict
from hypelcnn_tpu_torch.data import augmentation as aug
from hypelcnn_tpu_torch.data.loaders.synthetic import SyntheticDataLoader
from hypelcnn_tpu_torch.gan import shadow_ops
from hypelcnn_tpu_torch.gan.wrapper_registry import get_trainer_dict
from hypelcnn_tpu_torch.train.checkpoint import checkpoint_steps, save_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BANDS = 12
SPEC = f"synthetic://?h=48&w=64&bands={BANDS}&classes=5&seed=3"


def _patches(seed=0, batch=16, k=3):
    return np.random.default_rng(seed).uniform(0.05, 1.0, (batch, k, k, BANDS + 1)
                                               ).astype(np.float32)


def _ratio():
    loader = SyntheticDataLoader(SPEC)
    return loader.load_shadow_map(1, loader.load_data(1, True))[1]


@pytest.fixture(scope="module")
def gan_weights():
    """cycle_gan weights at random (std 0.05), as a flax tree and a state_dict."""
    trainer = jax_get_trainer_dict({}, BANDS, max_steps=1)["cycle_gan"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 0.05, np.shape(a)).astype(np.float32),
        jax.device_get(trainer.init_state(jax.random.key(0)).params))
    return trainer, params, variables_to_state_dict(params)


def _port_gan_struct(state_dict, device="cpu"):
    trainer = get_trainer_dict({}, BANDS, max_steps=1)["cycle_gan"]
    nets = trainer.build_nets()
    nets.load_state_dict(state_dict, strict=True)
    return shadow_ops.create_gan_shadow_struct(trainer, nets.to(device), BANDS)


def test_simple_shadow_op_matches_jax():
    x = _patches()
    ratio = _ratio()
    theirs = jax_shadow_ops.create_simple_shadow_struct(ratio)
    ours = shadow_ops.create_simple_shadow_struct(ratio, "cpu")
    for name in ("shadow_fn", "deshadow_fn"):
        expected = np.asarray(jax.vmap(getattr(theirs, name))(jnp.asarray(x)))
        np.testing.assert_array_equal(getattr(ours, name)(torch.from_numpy(x)).numpy(), expected)


def test_gan_shadow_op_matches_jax_and_passes_lidar_through(gan_weights):
    trainer, params, state_dict = gan_weights
    x = _patches(1)
    theirs = jax_shadow_ops.create_gan_shadow_struct(trainer, params, BANDS)
    ours = _port_gan_struct(state_dict)
    for name in ("shadow_fn", "deshadow_fn"):
        expected = np.asarray(jax.vmap(getattr(theirs, name))(jnp.asarray(x)))
        got = getattr(ours, name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got[..., -1], x[..., -1])
        assert not np.allclose(got[..., :BANDS], x[..., :BANDS])


def _jax_draws(key, batch, channels, amount):
    """Every draw that JAX's ``augment_batch`` takes from ``key``, by op."""
    k_rot, k_shadow, k_refl, k_spec = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_refl)
    return {
        "k": torch.from_numpy(np.array(jax.random.randint(k_rot, (batch,), 0, 3))),
        "u": torch.from_numpy(np.array(jax.random.uniform(k_shadow, (batch, 1, 1, 1)))),
        "flips": tuple(torch.from_numpy(np.array(jax.random.bernoulli(kk, 0.5, (batch,))))
                       for kk in (k1, k2)),
        "deltas": torch.from_numpy(np.array(jax.random.uniform(
            k_spec, (batch, 1, 1, channels), minval=-amount, maxval=0.0))),
    }


@pytest.mark.parametrize("method", ["simple", "cycle_gan"])
def test_augment_batch_with_shadow_matches_jax(gan_weights, method):
    """Rotation -> shadow (where u < threshold) -> reflection -> spectral."""
    trainer, params, state_dict = gan_weights
    x = _patches(2, batch=32)
    key = jax.random.PRNGKey(7)
    if method == "simple":
        jax_struct = jax_shadow_ops.create_simple_shadow_struct(_ratio())
        struct = shadow_ops.create_simple_shadow_struct(_ratio(), "cpu")
    else:
        jax_struct = jax_shadow_ops.create_gan_shadow_struct(trainer, params, BANDS)
        struct = _port_gan_struct(state_dict)
    flags = dict(perform_shadow_augmentation=True, perform_rotation_augmentation=True,
                 perform_reflection_augmentation=True, perform_spectral_augmentation=0.05,
                 augmentation_random_threshold=0.3)
    expected = np.asarray(jax_aug.augment_batch(
        jnp.asarray(x), key, jax_aug.AugmentationInfo(shadow_struct=jax_struct, **flags)))
    draws = _jax_draws(key, x.shape[0], x.shape[-1], 0.05)
    assert 0 < int((draws["u"] < 0.3).sum()) < 32
    got = aug.augment_batch(torch.from_numpy(x), aug.AugmentationInfo(shadow_struct=struct,
                                                                      **flags), draws=draws)
    if method == "simple":
        np.testing.assert_array_equal(got.numpy(), expected)
    else:
        np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)


def test_draw_streams_are_unchanged_with_shadow_augmentation_off():
    """Off (or without a shadow op): rotation, then reflection, then spectral
    draws, as before shadow augmentation existed. On: its ``u`` is the draw
    right after the rotation's."""
    x = torch.from_numpy(_patches(3))
    b, c = x.shape[0], x.shape[-1]
    flags = dict(perform_rotation_augmentation=True, perform_reflection_augmentation=True,
                 perform_spectral_augmentation=0.05)

    def expected(shadow_fn=None, threshold=0.4):
        gen = torch.Generator().manual_seed(11)
        out = aug.rotate_batch(x, k=torch.randint(0, 3, (b,), generator=gen))
        if shadow_fn is not None:
            u = torch.rand((b,), generator=gen)
            out = torch.where(u.view(-1, 1, 1, 1) < threshold, shadow_fn(out), out)
        flips = tuple(torch.rand((b,), generator=gen) < 0.5 for _ in range(2))
        out = aug.reflect_batch(out, flips=flips)
        return out + (torch.rand((b, 1, 1, c), generator=gen) * 0.05 - 0.05)

    for info in (aug.AugmentationInfo(**flags),
                 aug.AugmentationInfo(perform_shadow_augmentation=True, **flags)):
        got = aug.augment_batch(x, info, generator=torch.Generator().manual_seed(11))
        assert torch.equal(got, expected())
    struct = shadow_ops.create_simple_shadow_struct(_ratio(), "cpu")
    info = aug.AugmentationInfo(shadow_struct=struct, perform_shadow_augmentation=True,
                                augmentation_random_threshold=0.4, **flags)
    got = aug.augment_batch(x, info, generator=torch.Generator().manual_seed(11))
    assert torch.equal(got, expected(struct.shadow_fn))


def test_shadow_creators_restore_declared_snapshots(gan_weights, tmp_path, capsys):
    """``simple``; a GAN snapshot at its declared path; a TF checkpoint
    directory whose state file names no checkpoint and a corrupt snapshot are
    reported and left out (a TF checkpoint that reads is held in
    ``test_torch_tf_checkpoint.py``)."""
    _, _, state_dict = gan_weights
    base = tmp_path / "models"
    save_params(str(base / "shadow_gen_model" / "cycle_gan"), state_dict)
    (base / "shadow_gen_model" / "dcl_gan").mkdir(parents=True)
    (base / "shadow_gen_model" / "dcl_gan" / "checkpoint").write_text("model_checkpoint_path")
    (base / "shadow_gen_model" / "gan_x2y").mkdir()
    (base / "shadow_gen_model" / "gan_x2y" / "params.pt").write_bytes(b"not a checkpoint")
    loader = SyntheticDataLoader(SPEC + f"&base={base}")
    scene = loader.load_data(1, True)
    creators = shadow_ops.build_shadow_creators(loader, scene, 1, "cpu")
    assert sorted(creators) == ["cycle_gan", "simple"]
    out = capsys.readouterr().out
    assert "shadow creator dcl_gan: failed" in out and "no TF checkpoint under" in out
    assert "shadow creator gan_x2y: failed" in out
    x = torch.from_numpy(_patches(4))
    shadowed = creators["cycle_gan"].shadow_fn(x)
    assert torch.equal(shadowed[..., -1], x[..., -1])
    np.testing.assert_allclose(shadowed.numpy(), _port_gan_struct(state_dict).shadow_fn(x).numpy(),
                               rtol=0, atol=0)


@pytest.fixture(scope="module")
def trained_gan(tmp_path_factory):
    """A cycle_gan trained by the port's GAN CLI for 4 steps, its
    ``gan_params`` installed where the synthetic loader declares it."""
    root = tmp_path_factory.mktemp("gan")
    gan_train_for_shadow.main([
        "--loader_name=SyntheticDataLoader", f"--path={SPEC}", "--device=cpu", "--step=4",
        "--batch_size=8", "--validation_steps=4", "--validation_sample_count=10",
        f"--base_log_path={root / 'run'}"])
    (log_dir,) = [p for p in root.iterdir() if p.name.startswith("run_")]
    base = root / "models"
    (base / "shadow_gen_model").mkdir(parents=True)
    (log_dir / "gan_params").rename(base / "shadow_gen_model" / "cycle_gan")
    return base


@pytest.mark.parametrize("method", ["simple", "cycle_gan"])
def test_train_cli_with_shadow_augmentation_then_infer(trained_gan, tmp_path, method):
    path = SPEC + f"&base={trained_gan}"
    params = tmp_path / "params.json"
    params.write_text('{"filter_count": 32}')
    common = ["--loader_name=SyntheticDataLoader", f"--path={path}", "--neighborhood=1",
              f"--algorithm_param_path={params}", "--device=cpu"]
    result = train_for_classification.main(common + [
        "--importer_name=GeneratorImporter", "--step=6", "--batch_size=16",
        "--save_checkpoint_steps=3", f"--augment_data_with_shadow={method}",
        "--augmentation_random_threshold=0.3", f"--base_log_path={tmp_path / 'log'}"])
    (log_dir,) = (tmp_path / "log").iterdir()
    assert log_dir.name.endswith(f"_3x3_{method}_aug030")
    assert checkpoint_steps(str(log_dir)) == [3, 6] and np.isfinite(result.loss)
    infer_for_classification.main(common + [f"--base_log_path={log_dir}",
                                            f"--output_path={tmp_path / 'out'}", "--domain=all"])
    assert (tmp_path / "out" / "result_raw.tif").is_file()


def test_unknown_shadow_method_names_the_available_ones(trained_gan, tmp_path):
    with pytest.raises(KeyError, match=r"available: \['cycle_gan', 'simple'\]"):
        train_for_classification.main([
            "--loader_name=SyntheticDataLoader", f"--path={SPEC}&base={trained_gan}",
            "--neighborhood=1", "--device=cpu", "--importer_name=GeneratorImporter",
            "--step=2", "--augment_data_with_shadow=cyclegan",
            f"--base_log_path={tmp_path}"])
